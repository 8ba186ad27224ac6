#!/usr/bin/env python
"""Time kernels 1 and 10 and the DSFVT b64 training steps of this checkout
beside another checkout of the repository (a parent commit unpacked with
``git archive`` into a git-ignored directory), on one card, in turns: other,
this, this, other.

Each turn runs, in a fresh process from that tree's root, the tree's own
``chip_smoke.py`` phases: device, build, kernels (phase 3: kernel 1 at
nb=16 beside its library call and bound), train kernels (phase 6: kernels 10
and 1 at nb=64) and train (phase 8: the fused and unfused steps, each with
one profiled step by ``__global__`` function). Each turn's whole output goes
to ``<out-dir>/ab_<turn>_<tree>.txt`` (default ``output/ab_attention``); the
lines with the numbers are printed. ``--kernels-only`` leaves out phase 8. Needs a CUDA card.

    git archive HEAD | tar -x -C build/parent
    python tools/ab_attention_torch.py --other build/parent
"""

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("import chip_smoke as c\n"
          "card = c.phase_device()\n"
          "c.phase_build()\n"
          "c.phase_kernels(card)\n"
          "c.phase_train_kernels(card)\n")
TRAIN = "c.phase_train(card)\n"
KEEP = ("kernel 1 ", "kernel 10 ", "  time ", "bf16 nb=", "train DSFVT", "profile, one train",
        "hand-written kernels per step", "H100", "build:")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="root of the other checkout")
    parser.add_argument("--timeout", type=int, default=600, help="seconds per turn")
    parser.add_argument("--out-dir", default=os.path.join(ROOT, "output", "ab_attention"),
                        help="directory of the turns' whole logs")
    parser.add_argument("--kernels-only", action="store_true",
                        help="phases 1-3 and 6 only, without the training steps")
    args = parser.parse_args(argv)
    other = os.path.abspath(args.other)
    out_dir = os.path.abspath(args.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    failed = 0
    for turn, (name, root) in enumerate((("other", other), ("this", ROOT), ("this", ROOT),
                                         ("other", other))):
        print(f"=== turn {turn}: {name} ({root})", flush=True)
        code = PHASES if args.kernels_only else PHASES + TRAIN
        proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                              text=True, timeout=args.timeout)
        log = os.path.join(out_dir, f"ab_{turn}_{name}.txt")
        with open(log, "w") as f:
            f.write(proc.stdout + proc.stderr)
        for line in proc.stdout.splitlines():
            if any(k in line for k in KEEP):
                print(line[:400])
        if proc.returncode != 0:
            failed += 1
            print(f"turn {turn} ({name}) exited {proc.returncode}; see {log}:\n"
                  + proc.stderr[-2000:])
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
