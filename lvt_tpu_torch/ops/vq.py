"""Vector quantization, inference only (counterpart of the encode/embed half
of lvt_tpu/ops/vq.py).

Nearest code by the expansion ``||c||^2 + ||z||^2 - 2 z.c`` in fp32, summed
in the JAX package's order; ``torch.argmin`` takes the lowest index among
equal minima, as ``jnp.argmin`` does. This is plain PyTorch with TF32 off
(``lvt_tpu_torch/__init__.py``), the counterpart of the HIGHEST-precision
XLA path that ``encode_indices`` uses in the JAX package; the Pallas
nearest-code kernel there serves VQ-VAE training and is not on this path.

A codebook is a dict with the fields of lvt_tpu's ``EmaCodebookState``:
``embedding`` (num, K, Dc), ``running_size`` (num, K), ``running_sum``
(num, K, Dc).
"""

from typing import Dict

import torch

Codebook = Dict[str, torch.Tensor]


def _distances(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, Dc) x (K, Dc) -> (N, K) squared-distance surrogate in fp32."""
    z = z.float()
    codebook = codebook.float()
    c_sqr = (codebook ** 2).sum(dim=1)
    z_sqr = (z ** 2).sum(dim=1, keepdim=True)
    cross = z @ codebook.T
    return c_sqr[None, :] + z_sqr - 2.0 * cross


def nearest_indices(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin_k ||z - c_k||^2, ties to the lowest index. z: (N, Dc) -> (N,)
    int32."""
    return torch.argmin(_distances(z, codebook), dim=1).to(torch.int32)


def encode_indices(z_e: torch.Tensor, codebook: Codebook) -> torch.Tensor:
    """(..., D) -> (..., num) int32 codebook indices."""
    emb = codebook["embedding"]
    num, K, Dc = emb.shape
    lead = z_e.shape[:-1]
    z = z_e.reshape(-1, num, Dc)
    idx = [nearest_indices(z[:, i, :], emb[i]) for i in range(num)]
    return torch.stack(idx, dim=1).reshape(lead + (num,))


def embed_indices(indices: torch.Tensor, codebook: Codebook) -> torch.Tensor:
    """(..., num) int -> (..., D) embeddings, chunk-concatenated."""
    emb = codebook["embedding"]
    parts = [emb[i][indices[..., i].long()] for i in range(emb.shape[0])]
    return torch.cat(parts, dim=-1)
