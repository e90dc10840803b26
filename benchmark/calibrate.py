"""Readings for a cell's limits: the program on many seeds, and the control
(and, for training, the planted fault) on a few, in one process.

    python3 benchmark/calibrate.py --workload <cell> --first-seed <n> --seeds 12 \
        --control-seeds 3 --calls 4 > readings.jsonl

For each seed it sets the cell up as a run does, makes ``--calls`` calls of
the timed path, and checks them against the reference: one JSON line of the
numbers ("program"). For the first ``--control-seeds`` seeds it also reads
the driver's control and faults in the program's place, one line each. The
benchmark's runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--calls", type=int, default=4)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    drv = harness.driver(cell["traffic_spec"]["driver"])
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        session = drv.setup(cell, seed, device)
        for _ in range(args.calls):
            session.call()
        out, _ = session.finish()
        del session
        rows = [("program", drv.check(cell, seed, out, device))]
        if i < args.control_seeds:
            rows += list(drv.control(cell, seed, out, device).items())
        for kind, numbers in rows:
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind, **numbers}),
                  flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
