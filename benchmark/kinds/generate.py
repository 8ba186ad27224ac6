"""Generation traffic: batches of videos back to back through the port's
entry ``scripts/generate_videos_torch.py`` (``encode_priming``, then
``generate(primed=...)``): the priming frames encoded by the VQ-VAE, the
VT's rollout (one CUDA-graph replay a sampled slice), the decode.

Every batch samples at the entry's temperature 1, as the CLI does, batch i
from a generator seeded from the seed and i
(``lvtbench.traffic.sampling_generator``), on the one VideoTransformer and
rollout graph a user's run holds.

Traffic keys: ``batch`` videos a batch; ``sampler``: the port's
TEST.VT_SAMPLER knobs; ``staged_batches``: batches of priming frames made
on the card before the window (batch i takes staged batch i mod that);
``check_rows``: videos of each batch kept for the check, drawn from the
seed; ``check_videos``: of the kept videos, how many the VT check takes
(drawn from the seed; the VQ-VAE checks take all kept).

Set-up: the seed's weights (the VT in the configuration's dtype, the
VQ-VAE in float32), the staged frames, one warm-up batch, whose first slice
captures the rollout's CUDA graph. The window runs whole batches
(``lvtbench.window.run_batches``); a traced run then profiles one more.
"""

import gc
import time

import torch

from lvtbench import checks, program, timeline, traffic, weights, window
from reference import vt as rvt


def _span(name):
    return torch.profiler.record_function(timeline.SPAN_PREFIX + name)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counts():
    from lvt_tpu_torch.ops._lib import COUNTED

    return {fn.__name__: fn.launches for fn in COUNTED}


def run(r):
    if r.world != 1:
        raise ValueError("the generation kind runs on one card")
    conf, tr, dev, seed = r.cell.config, r.cell.traffic, r.device, r.seed
    gv = program.generation_entry()
    from lvt_tpu_torch.models.rollout_graph import SliceGraph
    from lvt_tpu_torch.models.vqvae import VQVAE
    from lvt_tpu_torch.models.vt import VideoTransformer

    cfg = program.port_cfg(conf, tr, seed)
    v, q, video = conf["vt"], conf["vqvae"], conf["video"]
    dtype = getattr(torch, conf["dtype"])
    b, n_prime, nv = tr["batch"], video["N_PRIME_TEST"], v["NV"]
    T, H, W = video["T"], video["H"], video["W"]
    fh, fw = q["FRAME"]

    vt_params = {"netG": weights.cast(weights.make_tree(
        rvt.param_specs(v), weights.stream_seed(seed, weights.VT_WEIGHTS), dev), dtype)}
    vq_params, vq_state = checks.vq_tree(q, seed, dev)
    vqvae = VQVAE(program.vqvae_cfg(conf))
    vt = VideoTransformer(cfg, T=T, H=H, W=W)
    sample = vt.sample_video

    def spanned(*a, **k):
        with _span("rollout"):
            return sample(*a, **k)
    vt.sample_video = spanned
    staged = [traffic.priming_frames(seed, i, b, n_prime, fh, fw, dev)
              for i in range(tr["staged_batches"])]

    def one_batch(i, frames):
        with _span("encode"):
            primed = gv.encode_priming(vqvae, vq_params, vq_state, frames)
            _sync(dev)
        t1 = time.perf_counter()
        with _span("generate"):
            out = gv.generate(vqvae, vq_params, vq_state, vt, vt_params, frames, n_prime,
                              traffic.sampling_generator(seed, i, dev), primed=primed)
            _sync(dev)
        return out, t1

    # warm-up: one batch, whose first slice captures the rollout's graph
    (_, codes, primed, _), _ = one_batch(-1, staged[0])
    if tuple(primed.shape[-2:]) != (H, W):
        raise ValueError(f"the VQ-VAE encodes {fh}x{fw} frames to {tuple(primed.shape[-2:])} "
                         f"latents; the configuration's video is {H}x{W}")
    del codes, primed
    r.layer["capture_s"] = SliceGraph.captures_seconds
    captures = SliceGraph.captures
    _sync(dev)
    r.setup_done()

    bad, kept, batches = [], [], []
    rows = tr["check_rows"]

    def do_batch(i):
        frames = staged[i % len(staged)]
        t0 = time.perf_counter()
        try:
            (vid, codes, primed, rollout_s), t1 = one_batch(i, frames)
        except Exception as e:  # a batch that raises counts as failed
            r.log(f"batch {i} failed: {type(e).__name__}: {e}")
            bad.append(torch.tensor(b))
            return
        t2 = time.perf_counter()
        ok = ((codes >= 0) & (codes < nv)).flatten(1).all(1) & torch.isfinite(vid).flatten(1).all(1)
        bad.append((~ok).sum())
        pick = torch.randperm(b, generator=torch.Generator().manual_seed(
            weights.stream_seed(seed, weights.CHECK, i)))[:rows]
        kept.append({"frames": frames[pick.to(dev)], "primed": primed[pick.to(dev)],
                     "codes": codes[pick.to(dev)], "video": vid[pick.to(dev)],
                     "batch": torch.full((len(pick),), i), "row": pick})
        batches.append({"encode_s": t1 - t0, "generate_s": t2 - t1, "rollout_s": rollout_s,
                        "videos": b})

    w = window.run_batches(do_batch, r.seconds)
    r.log("window: " + ", ".join(f"{e - s:.3f}" for s, e in zip([w.start] + w.ends[:-1], w.ends))
          + " s a batch")
    r.attempted = w.units * b
    r.failed = int(sum(int(x) for x in bad))
    done = sum(x["videos"] for x in batches)
    r.e2e["gen_frames_per_s"] = done * (T - n_prime) / w.seconds
    r.layer.update(window=w, batches=batches, in_window_captures=SliceGraph.captures - captures)
    if SliceGraph.captures != captures:
        r.log(f"the window captured {SliceGraph.captures - captures} graph(s): a capture "
              "inside the window")

    if r.trace:
        i = w.units
        frames = staged[i % len(staged)]
        before = _counts()
        _sync(dev)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with _span(timeline.STRETCH):
                one_batch(i, frames)
        after = _counts()
        r.trace_of(prof, batch=b, slices=len(rvt.sampled_slices(v, (T, H, W), n_prime)),
                   counts={k: after[k] - before[k] for k in after if after[k] != before[k]})
    r.read_peak()

    # the check, once the program's state is freed
    del vt, staged, vt_params, vq_params, vq_state, vqvae
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not kept:
        return
    rows_all = {k: torch.cat([x[k] for x in kept]) for k in kept[0]}
    n = len(rows_all["row"])
    take = torch.randperm(n, generator=torch.Generator().manual_seed(
        weights.stream_seed(seed, weights.CHECK)))[:tr["check_videos"]]
    rows_all["vt"] = torch.zeros(n, dtype=torch.bool)
    rows_all["vt"][take] = True
    for name, value in checks.gen_numbers(conf, seed, rows_all, b, dev).items():
        r.check(name, value)
