"""The VQ-VAE's convolutions (ResEncoder, ResDecoder; ``reference/vqvae.py``'s
layer lists): 2 x outputs x inputs x k^2 operations per frame for a
convolution, 2 x its input positions x in x out x k^2 for a transposed one.
The nearest-code search and the lookups are left out."""

from reference import vqvae as rvq


def _net(spec, hgt: int, wid: int) -> float:
    total = 0.0
    for layer in spec:
        if layer[0] == "conv":
            _, cin, cout, k, s, p = layer
            hgt, wid = (hgt + 2 * p - k) // s + 1, (wid + 2 * p - k) // s + 1
            total += 2.0 * hgt * wid * cin * cout * k * k
        elif layer[0] == "convT":
            _, cin, cout, k, s, p = layer
            total += 2.0 * hgt * wid * cin * cout * k * k
            hgt, wid = (hgt - 1) * s - 2 * p + k, (wid - 1) * s - 2 * p + k
        elif layer[0] == "resblock":
            _, dim, res = layer
            total += 2.0 * hgt * wid * (dim * res * 9 + res * dim)
    return total


def flops(q: dict, encoded: int, decoded: int) -> float:
    """Operations of encoding ``encoded`` frames and decoding ``decoded``."""
    fh, fw = q["FRAME"]
    enc = _net(rvq.encoder_spec(q), fh, fw)
    dec = _net(rvq.generator_spec(q), fh // 4, fw // 4)
    return encoded * enc + decoded * dec
