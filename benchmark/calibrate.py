"""The readings the limits of the correctness check are set from
(``benchmark/limits/<cell>.json``), on the card at the cell's own size:

    python benchmark/calibrate.py --workload <cell> --seeds 11,12,13 [--seconds 3]

Generation cells: a short run of the cell for each seed (``runner.run_cell``),
and on the same served videos and sampling draws, beside the program's
numbers, the control's: the reference in the precision below the
configuration's (fp8 for the bf16 VT, TF32 for the float32 VQ-VAE;
``reference.precision.CONTROL``) in the program's place. Training cells: for
each seed the reference's first steps and, in the program's place, the
control's, two planted faults' (half of each batch left out of the loss; one
code of each batch altered) and a step that leaves its state unchanged
(``update_gap`` 1 by construction). Each reading goes through the cell's
own comparison (``runner.checks_of`` against ``limits/<cell>.json``), which
gives its ``correct``: a control or a fault has to come out false. One JSON
line a seed. The program's own readings over seeds are the checks that
every run of the cell prints.
"""

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lvtbench import cells, checks, runner  # noqa: E402
from reference.precision import CONTROL  # noqa: E402

sys.path.append(cells.REPO)  # the port


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch

    cell = cells.cell(cells.load_benchmark(), args.workload)
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    conf = cell.config
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"cell": cell.name, "seed": seed}

        def judged(numbers):
            r = runner.Run(cell, seed, 0.0, False, dev, 0.0)
            r.numbers = dict(numbers)
            checks_, ok = runner.checks_of(r)
            return {"numbers": {k: v["value"] for k, v in checks_.items()}, "correct": ok}

        if cell.traffic["kind"] == "generate":
            plain = checks.gen_numbers

            def both(config, seed_, kept, batch, device, *a):
                line["control"] = judged(plain(config, seed_, kept, batch, device,
                                               CONTROL[config["dtype"]],
                                               CONTROL[config["vqvae_dtype"]]))
                return plain(config, seed_, kept, batch, device)

            checks.gen_numbers = both
            try:
                out, _, _ = runner.run_cell(cell, seed, args.seconds, False, dev,
                                            time.perf_counter())
            finally:
                checks.gen_numbers = plain
            line["program"] = {"numbers": {k: v["value"] for k, v in out["checks"].items()},
                               "correct": out["correct"]}
        else:
            from lvtbench import program

            cfg_seed = program.port_cfg(conf, cell.traffic, seed).SEED
            steps = cell.traffic["checked_steps"]
            ref = checks.train_reference(conf, cell.traffic, seed, cfg_seed, dev, steps)
            ctl = CONTROL[conf["train"]["TPU"]["COMPUTE_DTYPE"]]
            got = checks.train_reference(conf, cell.traffic, seed, cfg_seed, dev, steps, ctl)
            line["control"] = judged(checks.train_numbers(got, ref))
            for fault in ("half_batch", "token"):
                got = checks.train_reference(conf, cell.traffic, seed, cfg_seed, dev, steps,
                                             fault=fault)
                line[fault] = judged(checks.train_numbers(got, ref))
            line["state_unchanged"] = judged(checks.train_numbers(
                dict(ref, update=[0.0] * len(ref["update"])), ref))
        print(json.dumps(line), flush=True)

if __name__ == "__main__":
    main()
