"""The plain reference agrees with the port's plain path at tiny widths in
float32 (the VT's teacher-forced logits and loss, the VQ-VAE's codes and
frames), and a perturbed output fails the check."""

import pytest
import torch

from conftest import TINY_CONFIG, TINY_GEN_LIMITS
from lvtbench import checks, program, weights
from lvtbench.traffic import sampling_generator
from reference import vqvae as rvq
from reference import vt as rvt

SEED = 2 ** 31 + 11


def _port_vt():
    from lvt_tpu_torch.models.vt import VideoTransformer

    cfg = program.port_cfg(TINY_CONFIG, {}, SEED)
    cfg.TPU.FUSED_LAYER = False
    return VideoTransformer(cfg, T=4, H=4, W=4)


def _video(b=3):
    v = TINY_CONFIG["vt"]
    g = torch.Generator().manual_seed(5)
    return torch.randint(0, v["NV"], (b, v["NC"], 4, 4, 4), generator=g)


def test_vt_logits_and_loss_match_the_port():
    from lvt_tpu_torch.models.vt import vt_logits

    v = TINY_CONFIG["vt"]
    vt = _port_vt()
    params = checks.vt_tree(v, SEED, "cpu")
    video = _video()
    sidx = torch.tensor([1, 2, 3])
    ctx, sl, _ = rvt.prepare_slices(v, video, sidx)
    pctx, psl, _ = vt.prepare_slices(video, sidx)
    assert torch.equal(ctx, pctx) and torch.equal(sl, psl)
    want = vt_logits(params, vt.c, pctx, psl, sidx)
    got = rvt.logits(params, v, ctx, sl, sidx)
    assert (got - want).abs().max() < 2e-5
    loss, _ = vt.loss({"netG": params}, {"video": video}, slice_idx=sidx)
    ref = rvt.loss(params, v, video, sidx, v["N_PRIME"])
    assert abs(float(loss) - float(ref)) < 1e-5


def test_train_slices_are_the_trainers():
    from lvt_tpu_torch.engine.trainer import Trainer

    v = TINY_CONFIG["vt"]
    vt = _port_vt()
    seed = 1 + SEED % (2 ** 31 - 2)
    gen = Trainer.step_generator(type("T", (), {"seed": seed})(), 7)
    assert torch.equal(vt.sample_train_slice_idx(gen, 5),
                       rvt.train_slice_indices(v, seed, 7, 5, 4))


def test_vqvae_codes_and_frames_match_the_port():
    from lvt_tpu_torch.models.vqvae import VQVAE

    q = TINY_CONFIG["vqvae"]
    vq = VQVAE(program.vqvae_cfg(TINY_CONFIG))
    params, state = checks.vq_tree(q, SEED, "cpu")
    frames = torch.floor(torch.rand((5, 16, 16, 3), generator=torch.Generator().manual_seed(3))
                         * 256).clamp(max=255)
    codes = vq.encode(params, state, vq.normalize(frames / 255.0))
    assert torch.equal(codes.long(), rvq.encode(q, params, state, frames))
    port = (vq.denormalize(vq.decode(params, state, codes)) * 255.0).clamp(0, 255)
    assert (port - rvq.decode(q, params, state, codes)).abs().max() < 1e-3


def _served(seed=SEED, rows=2):
    """Rows served by the port's plain path (the CPU's generate), sampled at
    temperature 1 as window batch 0."""
    from lvt_tpu_torch.models.vqvae import VQVAE

    gv = program.generation_entry()
    v, q = TINY_CONFIG["vt"], TINY_CONFIG["vqvae"]
    vt = _port_vt()
    vq = VQVAE(program.vqvae_cfg(TINY_CONFIG))
    qp, qs = checks.vq_tree(q, seed, "cpu")
    params = {"netG": weights.make_tree(rvt.param_specs(v), weights.stream_seed(
        seed, weights.VT_WEIGHTS), "cpu")}
    frames = torch.floor(torch.rand((rows, 2, 16, 16, 3)) * 256).clamp(max=255)
    video, codes, primed, _ = gv.generate(vq, qp, qs, vt, params, frames, 2,
                                          sampling_generator(seed, 0, "cpu"))
    return {"frames": frames, "primed": primed, "codes": codes, "video": video,
            "batch": torch.zeros(rows, dtype=torch.long), "row": torch.arange(rows),
            "vt": torch.ones(rows, dtype=torch.bool)}


def _within(numbers):
    return all(numbers[k] <= lim for k, lim in TINY_GEN_LIMITS["limits"].items())


def test_served_rows_pass():
    assert _within(checks.gen_numbers(TINY_CONFIG, SEED, _served(), 2, "cpu"))


@pytest.mark.parametrize("fault", ["token", "code", "frame"])
def test_a_perturbed_output_fails(fault):
    kept = _served()
    if fault == "token":  # a sampled code of the last frame moved
        kept["codes"][0, 0, -1, 1, 2] = (kept["codes"][0, 0, -1, 1, 2] + 1) % 16
    elif fault == "code":
        kept["primed"][1, 1, 0, 2, 2] = (kept["primed"][1, 1, 0, 2, 2] + 5) % 16
    else:
        kept["video"][0, 3, 4, 5, 1] += 1.0
    numbers = checks.gen_numbers(TINY_CONFIG, SEED, kept, 2, "cpu")
    assert not _within(numbers), numbers
