"""The benchmark of the PyTorch port (lvt_tpu_torch) on NVIDIA H100 cards.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once, from the checkout's root: its set-up,
a window of about --seconds, with --trace 1 a profiled stretch after it, then
the check of what the window produced against the plain reference
(benchmark/reference). The last line of standard output is one JSON object:
correct, attempted, failed, metrics (--trace 0: the cell's end-to-end
metrics; --trace 1: its per-layer metrics), device, with --trace 1 a
breakdown, and last the checks, each number with its limit. The checks are
also the last lines of standard error.

Exits 2, printing no result, without enough CUDA cards for the cell; 3 if
the run loaded JAX or the JAX package.
"""

T0 = __import__("time").perf_counter()  # set-up is counted from here

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from lvtbench import cells, guard  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = cells.cell(cells.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    if cell.chips == 1:
        from lvtbench import runner

        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(0)
        out, lines, bad = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                          torch.device("cuda", 0), T0)
    else:
        from lvtbench import launch

        out, lines, bad = launch.spawn(cell.chips, cell, args.seed, args.seconds,
                                       bool(args.trace), "cuda", T0)
    bad = sorted(set(bad) | set(guard.forbidden_loaded()))
    if bad:
        print(f"the run loaded {bad}: the benchmark may load neither JAX nor the JAX package",
              file=sys.stderr)
        return 3
    print(f"card power limit: {_power_limit()}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def _power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"


if __name__ == "__main__":
    sys.exit(main())
