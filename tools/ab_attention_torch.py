#!/usr/bin/env python
"""Time the kernels and the DSFVT b64 training steps of this checkout beside
another checkout of the repository (a parent commit unpacked with
``git archive`` into a git-ignored directory), on one card, in turns: other,
this, this, other.

Each turn runs, in a fresh process from that tree's root (so that the
tree's own ``lvt_tpu_torch`` is imported and built), the phases of THIS
tree's ``chip_smoke.py`` named by ``--phases``: the same measuring code on
both trees, calling only the kernels' public wrappers. Phases:

* ``kernels``: phase 3, kernel 1 at nb=16 and kernel 2 at DSFVT shapes,
  beside their library calls and bounds, and kernel 2's sweep over b in
  (1, 8, 16) x live in (64, 256);
* ``train_kernels``: phase 6, kernels 10 and 1 at nb=64;
* ``fused_kernels``: phase 7, kernels 7, 8 and 9 at nb=64, whole and by
  ``__global__`` function;
* ``train``: phase 8, the fused and unfused training steps, each with one
  profiled step by ``__global__`` function; ``train_fused``: the fused one
  only;
* ``i8_kernels``: phase 10, kernels 3, 4, 5 and 11 (kernels 3 and 4 swept
  over b in 1, 8, 16 x live in 16, 64, 128, 256 through their (q8, sq)
  wrappers, and their fused entries where the tree has them; kernel 11 at
  DSFVT's three shapes x b in 1, 8, 16);
* ``i8_rollouts``: phase 11, the four greedy b8 rollouts (native and the
  three int8 modes), and one profiled slice of each (activities per pixel,
  device busy share);
* ``vq_kernel``: phase 13, kernel 6 at PR-DVQVAE2's step (all four
  sub-codebooks) and Base-VQVAE's; where the turn's tree has no grouped
  launch, its one-codebook wrapper is called once per sub-codebook.

Device and build (phases 1 and 2) always run first. Each turn's whole
output goes to ``<out-dir>/ab_<turn>_<tree>.txt`` (default
``output/ab_attention``); the lines holding any of the kept substrings
(the defaults below, plus ``--keep``) are printed. Needs a CUDA card.

    git archive HEAD | tar -x -C build/parent
    python tools/ab_attention_torch.py --other build/parent \\
        --phases i8_kernels,i8_rollouts
"""

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = {"kernels": "c.phase_kernels(card)\n",
         "train_kernels": "c.phase_train_kernels(card)\n",
         "fused_kernels": "c.phase_fused_kernels(card)\n",
         "train": "c.phase_train(card)\n",
         "train_fused": "c.phase_train(card, unfused=False)\n",
         "i8_kernels": "c.phase_i8_kernels(card)\n",
         "i8_rollouts": "c.phase_i8_rollouts(card)\n",
         "vq_kernel": "c.phase_vq_kernel(card)\n"}
# this tree's chip_smoke.py, the turn's tree's package (its root is the
# working directory, first on sys.path)
HEAD = ("import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', {path!r})\n"
        "c = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(c)\n"
        "import lvt_tpu_torch\n"
        "print('package:', lvt_tpu_torch.__file__)\n"
        "card = c.phase_device()\n"
        "c.phase_build()\n")
KEEP = ("kernel 1 ", "kernel 10 ", "  time ", "bf16 nb=", "kernel 2 ", "fused kernels",
        "layer times", "by __global__", "train DSFVT", "profile, one train",
        "hand-written kernels per step", "H100", "build:", "package:", "kernel 6 ",
        "kernel 11 ", "kernels 3 and 4", "kernel 3 ", "kernel 4 ", "kernel 5 ",
        "main path batch", "profile, one slice", "hand-written kernels in the slice")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="root of the other checkout")
    parser.add_argument("--phases", default="kernels,train_kernels,train",
                        help=f"comma-separated, of {', '.join(CALLS)}")
    parser.add_argument("--keep", action="append", default=[],
                        help="print output lines holding this substring too (repeatable)")
    parser.add_argument("--timeout", type=int, default=600, help="seconds per turn")
    parser.add_argument("--out-dir", default=os.path.join(ROOT, "output", "ab_attention"),
                        help="directory of the turns' whole logs")
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = [p for p in phases if p not in CALLS]
    if unknown:
        parser.error(f"unknown phases {unknown}; choose from {list(CALLS)}")
    code = HEAD.format(path=os.path.join(ROOT, "chip_smoke.py")) + "".join(CALLS[p]
                                                                         for p in phases)
    keep = KEEP + tuple(args.keep)
    other = os.path.abspath(args.other)
    out_dir = os.path.abspath(args.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    failed = 0
    for turn, (name, root) in enumerate((("other", other), ("this", ROOT), ("this", ROOT),
                                         ("other", other))):
        print(f"=== turn {turn}: {name} ({root}), phases {','.join(phases)}", flush=True)
        proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                              text=True, timeout=args.timeout)
        log = os.path.join(out_dir, f"ab_{turn}_{name}.txt")
        with open(log, "w") as f:
            f.write(proc.stdout + proc.stderr)
        for line in proc.stdout.splitlines():
            if any(k in line for k in keep):
                print(line[:400])
        if proc.returncode != 0:
            failed += 1
            print(f"turn {turn} ({name}) exited {proc.returncode}; see {log}:\n"
                  + proc.stderr[-2000:])
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
