"""The whole rollout's share of the card's roofline over the window (layer:
the whole generation batch): the least time the window's batches could take
on the card, over its measured time. Least time: each pixel step's larger of
its bytes over 3.35 TB/s and its operations over the compute dtype's peak
(``kernels/sample_step.py``), plus the VQ-VAE's operations over the float32
peak it runs at (``kernels/vqvae.py``: the priming frames encoded, every
frame decoded)."""

from lvtbench import cells, peaks


def read(r):
    batches = r.layer.get("batches")
    if not batches:
        return None
    conf, tr = r.cell.config, r.cell.traffic
    v, video, q = conf["vt"], conf["video"], conf["vqvae"]
    step, vq = cells.module("kernels", "sample_step"), cells.module("kernels", "vqvae")
    kv = tr.get("sampler", {}).get("KV_DTYPE", "native")
    least = 0.0
    for x in batches:
        b = x["videos"]
        nbytes, ops, steps = step.per_step(v, video, b, kv, conf["dtype"])
        least += steps * max(nbytes / peaks.PEAK_BYTES, ops / peaks.PEAK_FLOPS[conf["dtype"]])
        least += vq.flops(q, b * video["N_PRIME_TEST"], b * video["T"]) / peaks.PEAK_FLOPS[
            "float32"]
    return 100.0 * least / r.layer["window"].seconds
