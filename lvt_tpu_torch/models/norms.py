"""Normalization layers (counterpart of lvt_tpu/models/norms.py).

Only what the PR-DVQVAE2 VQ-VAE needs is ported: ``NORM: ""``, the
identity, which adds no layer, parameter or state. BN, FrozenBN, StdNorm
and the others come with VQ-VAE training.
"""

PORTED_NORMS = ("",)


def check_norm(norm: str) -> None:
    """Raise for a norm the port cannot build yet."""
    if norm not in PORTED_NORMS:
        raise NotImplementedError(f"norm {norm!r} is not ported to lvt_tpu_torch yet")
