#!/usr/bin/env python
"""Production soak of the PyTorch port's training loop; the counterpart of
tools/soak_train.py, with its options, defaults and JSON keys.

The real loop, not chained steps: ``DefaultTrainer.train`` with live hooks
(IterationTimer, PeriodicWriter -> metrics.json, PeriodicCheckpointer
pruned to --max-to-keep, EvalHook with BitsEvaluator on a held-out set)
over the port's loader (worker processes reading CodesExtractor-layout
.npy trees written from a seed, tools/bench_pipeline_torch.py
``gen_latents``), killed with SIGKILL in a child process (its whole process
group, the loader's workers with it) once --kill-after-ckpts checkpoint
periods are saved, and resumed with --resume in a second child.

Checks:
  * the resumed run starts at the iteration of the newest checkpoint on
    disk when the first child died (no reset to 0);
  * the loss curve splices across the kill (the mean after the resume point
    within 1.25x + 0.1 of the mean before it);
  * the cadence: every checkpoint kept is a multiple of CHECKPOINT_PERIOD or
    the final iteration, and the pruning: the newest --max-to-keep of them.

Usage:
  python tools/soak_train_torch.py                        # orchestrate: run, kill, resume, check
  python tools/soak_train_torch.py --iters 60 --ckpt-period 20 --kill-after-ckpts 2
  python tools/soak_train_torch.py --device cpu --iters 12 --ckpt-period 4 --batch 2 \\
      --writer-period 2 MODEL.AUTOREGRESSIVE.VT.D 16 ...   # KEY VALUE config overrides
  (internal) --child [--resume]: one training phase in this process

The children run on the card unless --device cpu is passed.
"""

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import numpy as np

WORKDIR = os.path.join(tempfile.gettempdir(), "lvt_soak_torch")


def build_cfg(args):
    """DSFVT.yaml with the soak's datasets (written here from a seed when
    missing, and registered), its schedule and the KEY VALUE overrides."""
    from bench_pipeline_torch import gen_latents

    from lvt_tpu_torch.config import get_cfg
    from lvt_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from lvt_tpu_torch.data.datasets.latents import get_latent_video_paths

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"))
    cfg.merge_from_list(list(args.opts))
    v = cfg.MODEL.AUTOREGRESSIVE.VT
    shape = dict(n_frames=cfg.INPUT.N_FRAMES_PER_VIDEO_TRAIN, nc=v.NC, nv=v.NV)
    train_root = os.path.join(args.workdir, "latents")
    test_root = os.path.join(args.workdir, "latents_test")
    gen_latents(train_root, n_videos=args.videos, **shape)
    gen_latents(test_root, n_videos=max(args.videos // 16, 2), seed=1, **shape)  # held out
    for name, root in (("soak_latents", train_root), ("soak_latents_test", test_root)):
        if name not in DatasetCatalog.list():
            DatasetCatalog.register(name, lambda r=root: get_latent_video_paths(r, use_cache=False))
            MetadataCatalog.get(name).set(root=root)
    cfg.DATASETS.TRAIN = ("soak_latents",)
    cfg.DATASETS.TEST = ("soak_latents_test",)
    cfg.SOLVER.MAX_ITER = args.iters
    cfg.SOLVER.CHECKPOINT_PERIOD = args.ckpt_period
    cfg.SOLVER.IMS_PER_BATCH = args.batch
    cfg.TEST.EVAL_PERIOD = args.eval_period
    cfg.TEST.EVALUATORS = "BitsEvaluator"
    cfg.OUTPUT_DIR = os.path.join(args.workdir, "out")
    cfg.SEED = 17
    return cfg


def run_phase(args):
    """One training phase in this process (the child the orchestrator kills
    and resumes)."""
    import logging

    from lvt_tpu_torch.engine.defaults import DefaultTrainer
    from lvt_tpu_torch.engine.hooks import PeriodicCheckpointer, PeriodicWriter

    class SoakTrainer(DefaultTrainer):
        """DefaultTrainer whose checkpointer prunes to --max-to-keep and
        whose metrics are written every --writer-period iterations."""

        def build_hooks(self):
            self.metrics_period = args.writer_period
            hooks = super().build_hooks()
            for i, h in enumerate(hooks):
                if isinstance(h, PeriodicCheckpointer):
                    hooks[i] = PeriodicCheckpointer(self.cfg.OUTPUT_DIR,
                                                    self.cfg.SOLVER.CHECKPOINT_PERIOD,
                                                    max_to_keep=args.max_to_keep)
                elif isinstance(h, PeriodicWriter):
                    hooks[i] = PeriodicWriter(self.build_writers(), period=args.writer_period)
            return hooks

    cfg = build_cfg(args)
    cfg.freeze()
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logging.basicConfig(level=logging.INFO)
    trainer = SoakTrainer(cfg, device=args.device)
    start = trainer.resume_or_load(resume=args.resume)
    print(f"[soak child] start_iter={start} max={cfg.SOLVER.MAX_ITER}", flush=True)
    trainer.train(start, cfg.SOLVER.MAX_ITER)
    from lvt_tpu_torch.ops._lib import COUNTED

    # the hand-written kernels' launches of this phase, by wrapper (none on the CPU)
    launches = {f.__name__: f.launches for f in COUNTED if f.launches}
    print(f"[soak child] launches {json.dumps(launches)}", flush=True)
    print("[soak child] training complete", flush=True)


def _ckpt_steps(ckpt_dir):
    """Steps of the finished checkpoints (``ckpt_<N>.pt``; a save in
    progress is a ``.tmp`` file until it is renamed)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                  if (m := re.fullmatch(r"ckpt_(\d+)\.pt", d)))


def _check(cond, msg):
    """A check of the soak (kept under ``python -O``, unlike assert)."""
    if not cond:
        raise RuntimeError(f"soak check failed: {msg}")


def _metrics(path):
    rows = []
    with open(path) as f:
        for line in f:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return rows


def orchestrate(args):
    """Run a child, SIGKILL it past the kill point, resume it, check; the
    JSON fields."""
    import shutil

    out = os.path.join(args.workdir, "out")
    ckpt_dir = os.path.join(out, "checkpoints")
    metrics_path = os.path.join(out, "metrics.json")
    if os.path.exists(out):
        shutil.rmtree(out)

    child_args = [sys.executable, os.path.abspath(__file__), "--child",
                  "--workdir", args.workdir, "--iters", str(args.iters),
                  "--ckpt-period", str(args.ckpt_period), "--batch", str(args.batch),
                  "--eval-period", str(args.eval_period), "--videos", str(args.videos),
                  "--max-to-keep", str(args.max_to_keep),
                  "--writer-period", str(args.writer_period), "--device", args.device]

    # ---- phase 1: train until the kill point's checkpoint is on disk, then
    # SIGKILL the child's process group: the child and its loader's worker
    # processes die together, as a preempted job does (a worker outliving its
    # trainer would block for ever on its full queue, holding the pipes it
    # inherited)
    p = subprocess.Popen(child_args + ["--resume"] + list(args.opts), start_new_session=True)
    kill_step = args.ckpt_period * args.kill_after_ckpts
    t0 = time.time()
    killed_at = None
    try:
        while p.poll() is None:
            time.sleep(args.poll)
            ckpts = _ckpt_steps(ckpt_dir)
            if ckpts and ckpts[-1] >= kill_step:
                # let it run on past the checkpoint, so the kill destroys progress
                time.sleep(args.kill_delay)
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
                # the newest checkpoint on disk when it died: a save may have
                # finished during the delay
                killed_at = _ckpt_steps(ckpt_dir)[-1]
                break
            if time.time() - t0 > args.phase_timeout:
                raise RuntimeError("phase 1 timed out before the kill point")
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    if killed_at is None:
        raise RuntimeError(f"child exited rc={p.returncode} before reaching the kill point")
    if killed_at >= args.iters:
        raise RuntimeError(f"the kill landed after the run's end (ckpt_{killed_at}): "
                           "lengthen the run (--iters) or shorten --kill-delay")
    pre_iters = [r["iteration"] for r in _metrics(metrics_path) if "total_loss" in r]
    print(f"[soak] SIGKILLed mid-run after checkpoint ckpt_{killed_at}; metrics flushed "
          f"through iter {max(pre_iters, default=None)}", flush=True)

    # ---- phase 2: --resume to completion (the child's printed start_iter is
    # the evidence of no reset to 0: metrics.json cannot show it when the
    # kill landed before the writer's next flush)
    p2 = subprocess.run(child_args + ["--resume"] + list(args.opts), capture_output=True,
                        text=True, timeout=args.phase_timeout)
    sys.stdout.write(p2.stdout)
    sys.stderr.write(p2.stderr[-4000:])
    if p2.returncode != 0:
        raise RuntimeError(f"resume phase failed rc={p2.returncode}")
    m = re.search(r"\[soak child\] start_iter=(\d+)", p2.stdout)
    _check(m, "resume child never reported its start iteration")
    resume_start = int(m.group(1))
    m = re.search(r"\[soak child\] launches (\{.*\})", p2.stdout)
    _check(m, "resume child never reported its launches")
    resume_launches = json.loads(m.group(1))
    _check(resume_start == killed_at,
           f"resume did not restart at the checkpoint (start_iter={resume_start}, "
           f"ckpt={killed_at})")

    # ---- check
    rows = _metrics(metrics_path)
    loss_rows = [r for r in rows if "total_loss" in r]
    iters = [r["iteration"] for r in loss_rows]
    final_iter = max(iters)
    _check(final_iter == args.iters - 1, f"last metrics row {final_iter}, want {args.iters - 1}")

    # loss continuity across the kill: window means on either side of the
    # resume point (rows past killed_at from both children belong to one curve)
    win = max(args.ckpt_period, 100)
    pre_kill = [r["total_loss"] for r in loss_rows if killed_at - win <= r["iteration"] < killed_at]
    post = [r["total_loss"] for r in loss_rows if killed_at <= r["iteration"] < killed_at + win]
    _check(pre_kill and post,
           f"metrics windows empty around the splice (pre={len(pre_kill)}, post={len(post)}): "
           "writer period vs checkpoint period mismatch")
    pre_m, post_m = float(np.mean(pre_kill)), float(np.mean(post))
    _check(post_m <= pre_m * 1.25 + 0.1, f"loss curve did not splice: {pre_m:.4f} -> {post_m:.4f}")

    # cadence and pruning: the newest max_to_keep of the period's multiples
    # and the final iteration
    kept = _ckpt_steps(ckpt_dir)
    saved = sorted(set(range(args.ckpt_period, args.iters, args.ckpt_period)) | {args.iters})
    want = saved[-args.max_to_keep:] if args.max_to_keep > 0 else saved
    _check(kept == want, f"checkpoints kept {kept}, want {want}")

    times = [r["time"] for r in loss_rows if "time" in r]
    sec_it = float(np.median(times)) if times else None
    evals = [r for r in rows if any(k.startswith("eval/") for k in r)]
    return {
        "mode": "soak_train", "config": "DSFVT.yaml", "batch": args.batch,
        "iters": args.iters, "ckpt_period": args.ckpt_period,
        "killed_after_ckpt": killed_at, "resume_start_iter": resume_start,
        "final_iter": final_iter,
        "sec_per_iter_median": round(sec_it, 4) if sec_it else None,
        f"loss_pre_kill_mean{win}": round(pre_m, 4),
        f"loss_post_resume_mean{win}": round(post_m, 4),
        "eval_rows": len(evals),
        "checkpoints_kept": kept,
        "max_to_keep": args.max_to_keep, "device": args.device,
        "resume_launches": resume_launches,
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default=WORKDIR)
    p.add_argument("--iters", type=int, default=1500)
    p.add_argument("--ckpt-period", type=int, default=200)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--eval-period", type=int, default=500)
    p.add_argument("--kill-after-ckpts", type=int, default=3,
                   help="SIGKILL once this many checkpoint periods are saved")
    p.add_argument("--kill-delay", type=float, default=10.0,
                   help="seconds past the checkpoint before the SIGKILL (so the kill "
                        "destroys un-checkpointed progress)")
    p.add_argument("--phase-timeout", type=float, default=3000.0)
    p.add_argument("--poll", type=float, default=5.0,
                   help="seconds between two looks at the checkpoint directory")
    p.add_argument("--max-to-keep", type=int, default=3,
                   help="PeriodicCheckpointer prunes to this many checkpoints (0: all)")
    p.add_argument("--writer-period", type=int, default=20,
                   help="iterations between two metrics.json rows (DefaultTrainer's 20)")
    p.add_argument("--videos", type=int, default=512,
                   help="training videos written (the held-out set has 1/16 of them)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--child", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: soak_train_torch runs on the card "
                             "(--device cpu for the CPU)")
    if args.child:
        run_phase(args)
        return None
    out = orchestrate(args)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
