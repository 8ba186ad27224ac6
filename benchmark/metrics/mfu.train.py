"""The whole train step's share of the card's peak over the window (layer:
the trainer's step): the analytic matmul operations of a step
(``kernels/vt_train.py``) times the window's steps, over its time, against
the compute dtype's peak (989 TFLOP/s in bf16). The context encode's
one-hot work and the optimizer are not counted (see there)."""

from lvtbench import cells, peaks


def read(r):
    w = r.layer.get("window")
    if w is None or not w.units:
        return None
    conf = r.cell.config
    ops = cells.module("kernels", "vt_train").flops(conf["vt"], conf["video"], r.layer["batch"])
    dtype = conf["train"]["TPU"]["COMPUTE_DTYPE"]
    return 100.0 * ops * w.units / w.seconds / peaks.PEAK_FLOPS[dtype]
