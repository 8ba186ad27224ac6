"""Kernels 7, 8 and 9's share of their roofline in the traced train steps
(layer: kernels, ``ops/fused_layer.py``): the least time of their calls
(``kernels/fused_layer.py``: each call's larger of bytes over 3.35 TB/s and
operations over 989 TFLOP/s; the encoder's layers full, the decoder's
causal), summed, over the summed device time of their __global__ functions
in the profile. Each of the three wrappers must have launched once a layer
and step (the port's launch counters), or nothing is read."""

from lvtbench import cells, peaks, timeline


def read(r):
    tl = r.timeline
    if tl is None or "steps" not in r.stretch:
        return None
    k = cells.module("kernels", "fused_layer")
    v, video = r.cell.config["vt"], r.cell.config["video"]
    st, sh, sw = v["STRIDE"]
    t, h, w = video["T"] // st, video["H"] // sh, video["W"] // sw
    steps, batch = r.stretch["steps"], r.stretch["batch"]
    el = 2 if r.cell.config["dtype"] == "bfloat16" else 4
    dtype = r.cell.config["dtype"]
    least, by = 0.0, set()
    for blocks, heads, causal in ((v["BLOCKS_E"], v["N_HEAD_E"], False),
                                  (v["BLOCKS_D"], v["N_HEAD_D"], True)):
        for (bt, bh, bw), na in zip(blocks, heads):
            n = bt * bh * bw
            nb = batch * (t * h * w) // n
            for nbytes, ops in k.counts(nb, n, v["D"], na, v["DA"], causal, el).values():
                ms, kind = peaks.bound_ms(dtype, nbytes, ops)
                least += steps * ms / 1e3
                by.add(kind)
    layers = len(v["BLOCKS_E"]) + len(v["BLOCKS_D"])
    launched = [r.stretch["counts"].get(name, 0) for name in k.WRAPPERS.values()]
    seconds, seen = timeline.seconds_of(tl, k.KEYS)
    if seen == 0 or any(n != steps * layers for n in launched):
        r.log(f"fused_layer_roofline: launches {launched}, expected {steps * layers} "
              f"each, {seen} activities: not read")
        return None
    r.log(f"fused_layer_roofline: bound by {'/'.join(sorted(by))}, {least * 1e3:.3f} ms "
          f"against {seconds * 1e3:.3f} ms of kernels 7-9 in {steps} steps")
    return 100.0 * least / seconds
