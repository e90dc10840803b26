"""Run one benchmark cell of the PyTorch/CUDA port on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's files (``benchmark/workloads/<cell>.json`` and what it
names), builds the port's model with weights drawn from the seed on the
card, warms up, measures for ``--seconds``, checks the timed outputs against
the plain reference, and prints one JSON line last on standard output. It
exits non-zero, printing no result, without a CUDA card (or with fewer than
the cell asks for), or when a JAX module is loaded at the end. The port's
kernel libraries are built once into ``build/`` of this checkout.
"""

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(CHECKOUT))
# Kernel caches at fixed paths inside the checkout.
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), PROCESS_START)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"modules that the run may not load: {found}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
