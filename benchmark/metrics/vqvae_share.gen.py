"""VQ-VAE inference's share of the window's time (layer: VQ-VAE
inference, ``models/vqvae.py``, ``ops/vq.py`` kernel 6), from the
benchmark's synchronized spans of every batch in the window: the encode
around ``encode_priming``, and of ``generate`` (called with the primed
codes) its time less its own returned rollout seconds (the decode, with the
few launches that set up the rollout's video)."""


def read(r):
    batches = r.layer.get("batches")
    if not batches:
        return None
    vq = sum(x["encode_s"] + x["generate_s"] - x["rollout_s"] for x in batches)
    return 100.0 * vq / r.layer["window"].seconds
