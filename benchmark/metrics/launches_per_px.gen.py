"""Device activities (kernels, copies, sets) a pixel step (layer: the
sampler and its rollout graph, ``models/vt.py`` ``sample_video``,
``models/rollout_graph.py``, ``models/vt_incremental.py``), from the traced
stretch: every activity that starts after the encode span has ended (the
rollout's replays and the decode's few), over the stretch's pixel steps."""

from lvtbench import timeline


def read(r):
    tl = r.timeline
    if tl is None or "slices" not in r.stretch:
        return None
    enc = timeline.span(tl, "encode")
    if not enc:
        return None
    v, video = r.cell.config["vt"], r.cell.config["video"]
    st, sh, sw = v["STRIDE"]
    thw = (video["T"] // st) * (video["H"] // sh) * (video["W"] // sw)
    return timeline.activities_after(tl, enc[0][1]) / (r.stretch["slices"] * thw)
