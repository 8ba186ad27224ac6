"""Training traffic: the port's ``Trainer.run_step`` and ``after_step``
back to back (``engine/trainer.py``: each step takes a new host batch from
the loader through ``_put_batch``, the loss and backward in the
configuration's compute dtype on fp32 masters, the optimizer's update),
on the configuration's global batch of code clips.

Traffic keys: ``pool`` distinct clips made from the seed on the host, which
the loader (``lvtbench.traffic.ClipLoader``) serves in a seed-drawn order;
``checked_steps`` steps that set-up drives first and the reference follows;
``trace_steps`` steps a traced run profiles after the window.

Set-up builds one Trainer over the seed's weights (handed to it as the
model's init), drives its first ``checked_steps`` steps, reading the
program's numbers for the check on the way (the losses; the first step's
gradient norms from RMSprop's state; each leaf's change), and hands the
same trainer to the window.
"""

import gc
import math
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
        raise ValueError("the training kind runs on one card")
    conf, tr, dev, seed = r.cell.config, r.cell.traffic, r.device, r.seed
    from lvt_tpu_torch.engine.trainer import Trainer
    from lvt_tpu_torch.models.vt import VideoTransformer
    from lvt_tpu_torch.utils.events import EventStorage

    cfg = program.port_cfg(conf, tr, seed)
    v, video = conf["vt"], conf["video"]
    T, H, W = video["T"], video["H"], video["W"]
    batch = cfg.SOLVER.IMS_PER_BATCH
    alpha = cfg.SOLVER.RMSPROP.ALPHA_G
    checked = tr["checked_steps"]

    start = weights.make_tree(rvt.param_specs(v), weights.stream_seed(seed, weights.VT_WEIGHTS),
                              dev)
    model = VideoTransformer(cfg, T=T, H=H, W=W)
    model.init = lambda gen, device: ({"netG": start}, {})
    loader = traffic.ClipLoader(seed, tr["pool"], batch, v["NC"], v["NV"], (T, H, W))
    trainer = Trainer(cfg, loader, model=model, device=dev)
    masters = weights.leaves(trainer.state.params)
    opt = trainer.state.optimizer

    with EventStorage(0) as storage:
        trainer.storage = storage
        trainer.max_iter = 2 ** 62
        failed = [0]

        def step(i):
            trainer.iter = i
            trainer.before_step()
            try:
                trainer.run_step()
                trainer.after_step()
            except FloatingPointError as e:  # a non-finite loss at a flush
                r.log(f"step {i}: {e}")
                failed[0] += 1
            storage.step()

        # the checked steps: the program's numbers, read as the steps go
        grad = None
        for i in range(checked):
            step(i)
            if i == 0:  # a leaf with no RMSprop state has not moved: norm 0
                grad = torch.stack([torch.sqrt(opt.state[p]["square_avg"].double().sum()
                                               / (1.0 - alpha)) if "square_avg" in opt.state[p]
                                    else torch.zeros((), dtype=torch.float64, device=dev)
                                    for p in masters])
        first = weights.make_tree(rvt.param_specs(v), weights.stream_seed(
            seed, weights.VT_WEIGHTS), dev)
        moved = torch.stack([(p.detach() - p0).double().norm()
                             for p, p0 in zip(masters, weights.leaves(first))])
        del first
        trainer.flush_metrics()
        losses = [x for x, _ in storage.history("loss_cross_entropy").values()]
        got = {"loss": losses, "grad": grad.tolist(), "update": moved.tolist()}
        _sync(dev)
        r.setup_done()

        n0 = checked
        flushed = []  # host time after each step that flushes (a host read of its metrics)

        def window_step(i):
            step(n0 + i)
            if (n0 + i + 1) % trainer.metrics_period == 0:
                flushed.append(time.perf_counter())

        w = window.run_steps(window_step, lambda: _sync(dev), r.seconds)
        r.log(f"window: {w.units} steps; seconds between flushes "
              + ", ".join(f"{b - a:.3f}" for a, b in zip([w.start] + flushed, flushed + [w.end])))
        trainer.flush_metrics()
        r.attempted = w.units
        data = storage.history("data_time").values()
        window_data = [x for x, it in data if it >= n0]
        losses_all = [x for x, it in storage.history("total_loss").values() if it >= n0]
        r.failed = failed[0] + sum(1 for x in losses_all if not math.isfinite(x))
        r.e2e["train_clips_per_s"] = w.units * batch / w.seconds
        r.layer.update(window=w, data_time=window_data, batch=batch)

        if r.trace:
            n1 = n0 + w.units
            before = _counts()
            _sync(dev)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                with _span(timeline.STRETCH):
                    for i in range(tr["trace_steps"]):
                        trainer.iter = n1 + i
                        trainer.before_step()
                        with _span("run_step"):
                            trainer.run_step()
                        with _span("flush"):
                            trainer.after_step()
                        storage.step()
                    _sync(dev)
            after = _counts()
            r.trace_of(prof, steps=tr["trace_steps"], batch=batch,
                       counts={k: after[k] - before[k] for k in after if after[k] != before[k]})
        r.read_peak()

    del trainer, model, loader, masters, opt, start
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = checks.train_reference(conf, tr, seed, cfg.SEED, dev, checked)
    for name, value in checks.train_numbers(got, ref).items():
        r.check(name, value)
