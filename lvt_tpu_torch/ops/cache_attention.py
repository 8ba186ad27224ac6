"""Per-pixel decode attention over a native-dtype KV cache (counterpart of
the native-KV step of lvt_tpu/models/vt_incremental.py:510-546 and of its
Pallas twin lvt_tpu/ops/cache_attention.py:decode_attention_pallas).

The port's cache keeps heads apart: one layer's K and V are (b, na, R, da),
preallocated at R = the block run and written in place one row per pixel.
``decode_attention`` reads rows [0, live) only. On a CUDA tensor it launches
the hand-written kernel (csrc/decode_attention.cu); on a CPU tensor it runs
the plain PyTorch version of the same function.
"""

import torch

from ._lib import LIBRARY, check_launch


def decode_attention_plain(q, kc, vc, live: int, bias, scale: float) -> torch.Tensor:
    """Plain PyTorch version of kernel 2. q (b, na, da) in the cache dtype;
    kc, vc (b, na, R, da); bias (na, R) fp32. Logits and softmax in fp32,
    weights rounded to the cache dtype before the V product, output
    (b, na*da) in the cache dtype."""
    b, na, da = q.shape
    k = kc[:, :, :live].float()
    v = vc[:, :, :live].float()
    logits = torch.einsum("bak,bajk->baj", q.float(), k) * scale + bias[None, :, :live].float()
    w = torch.softmax(logits, dim=-1).to(kc.dtype).float()
    out = torch.einsum("baj,bajk->bak", w, v)
    return out.to(kc.dtype).reshape(b, na * da)


def decode_attention_cuda(q, kc, vc, live: int, bias, scale: float) -> torch.Tensor:
    """Kernel 2 (csrc/decode_attention.cu) on CUDA tensors: the shapes and
    types of ``decode_attention_plain``, all contiguous, da in {64, 128}."""
    if not (q.is_cuda and kc.device == q.device and vc.device == q.device
            and bias.device == q.device):
        raise ValueError("decode_attention_cuda: all inputs must be on one CUDA device")
    if kc.dtype not in (torch.float32, torch.bfloat16) or vc.dtype != kc.dtype \
            or q.dtype != kc.dtype:
        raise ValueError(f"decode_attention_cuda: q and the caches must share float32 or "
                         f"bfloat16, got {q.dtype}, {kc.dtype}, {vc.dtype}")
    if bias.dtype != torch.float32:
        raise ValueError(f"decode_attention_cuda: bias must be float32, got {bias.dtype}")
    if q.dim() != 3 or kc.dim() != 4 or vc.shape != kc.shape:
        raise ValueError(f"decode_attention_cuda: want q (b, na, da) and caches "
                         f"(b, na, R, da), got {tuple(q.shape)}, {tuple(kc.shape)}, "
                         f"{tuple(vc.shape)}")
    b, na, R, da = kc.shape
    if tuple(q.shape) != (b, na, da) or tuple(bias.shape) != (na, R):
        raise ValueError(f"decode_attention_cuda: q must be {(b, na, da)} and bias "
                         f"{(na, R)}, got {tuple(q.shape)}, {tuple(bias.shape)}")
    if da not in (64, 128) or not 1 <= live <= R or R > 32768:
        raise ValueError(f"decode_attention_cuda: needs da in (64, 128) and "
                         f"1 <= live <= R <= 32768, got da={da}, live={live}, R={R}")
    if not all(t.is_contiguous() for t in (q, kc, vc, bias)):
        raise ValueError("decode_attention_cuda: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, kc, vc)):  # the kernel reads them 16 bytes at a time
        raise ValueError("decode_attention_cuda: q, kc, vc must be 16-byte aligned")
    lib = LIBRARY.get()
    out = torch.empty((b, na * da), dtype=kc.dtype, device=kc.device)
    if q.device.index != torch.cuda.current_device():
        raise ValueError("decode_attention_cuda: inputs must lie on the current CUDA device")
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.lvt_decode_attention(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, na, R, da, int(live), 0 if kc.dtype == torch.float32 else 1,
        float(scale), stream)
    check_launch("decode_attention", err)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0


def decode_attention(q, kc, vc, live: int, bias, scale: float) -> torch.Tensor:
    """Kernel 2 on a CUDA tensor, its plain version on a CPU tensor."""
    if kc.device.type == "cuda":
        return decode_attention_cuda(q.contiguous(), kc, vc, live, bias, scale)
    if kc.device.type == "cpu":
        return decode_attention_plain(q, kc, vc, live, bias, scale)
    raise ValueError(f"decode_attention: no kernel for device {kc.device}")
