"""Kernel 2's share of its roofline in the traced stretch (layer: kernels,
``ops/cache_attention.py`` ``lvt_decode_attention``): the least time its
calls could take, the bytes they need (``kernels/decode_attn.py``, at each
call's live rows) over 3.35 TB/s, or their operations over the peak
(``lvtbench.peaks.bound_ms``; bytes bound them), over their device time in
the profile. Where the profile holds fewer of its activities than the
rollout launched (a profile may drop records), the recorded calls' mean
time stands for the missing ones; the standard error says so."""

from lvtbench import cells, peaks, timeline


def read(r):
    tl = r.timeline
    if tl is None or "slices" not in r.stretch:
        return None
    k = cells.module("kernels", "decode_attn")
    v, video = r.cell.config["vt"], r.cell.config["video"]
    st, sh, sw = v["STRIDE"]
    t, h, w = video["T"] // st, video["H"] // sh, video["W"] // sw
    bt, bh, bw = v["BLOCKS_D"][0]
    rows = bt * h * w if (bh, bw) == (h, w) and t % bt == 0 else t * h * w
    el = 2 if r.cell.config["dtype"] == "bfloat16" else 4
    nbytes, ops, calls = k.rollout(r.stretch["batch"], v["N_HEAD_D"][0], v["DA"],
                                   len(v["BLOCKS_D"]), t * h * w, rows, r.stretch["slices"], el)
    launched = r.stretch["counts"].get(k.WRAPPER, 0)
    seconds, seen = timeline.seconds_of(tl, k.KEYS)
    if seen == 0 or launched != calls:
        r.log(f"decode_attn_roofline: {seen} activities in the profile, {launched} launched, "
              f"{calls} expected: not read")
        return None
    if seen < calls:
        r.log(f"decode_attn_roofline: the profile holds {seen} of {calls} calls")
        seconds *= calls / seen
    ms, by = peaks.bound_ms(r.cell.config["dtype"], nbytes, ops)
    bound = ms / 1e3
    r.log(f"decode_attn_roofline: bound by {by}, {nbytes / 1e9:.3f} GB and {ops / 1e9:.3f} "
          f"GFLOP in {calls} calls, {ms:.4f} ms against {seconds * 1e3:.4f} ms measured")
    return 100.0 * bound / seconds
