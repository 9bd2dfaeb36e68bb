"""Readings that set a cell's limits: the program as it runs (`sound`), the
control (the program at the next lower precision, `--dtype bfloat16`),
and the planted faults (`--fault half_batch | token | unchanged`), each on
several seeds in one process, at the cell's own sizes, with a short window.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--dtype bfloat16] [--fault token]

Prints one JSON line per seed: the numbers compared and whether the run was
sound.  The benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--dtype", default=None)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    import torch

    from harness import driver, spec

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("control readings are taken on the card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        work = tempfile.mkdtemp(prefix="emoasr_ctl_")
        t = time.perf_counter()
        try:
            line = driver.run_cell(cell, int(s), args.seconds, False, torch.device("cuda", 0), work, t,
                                   dtype=args.dtype, fault=args.fault)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": int(s), "dtype": args.dtype, "fault": args.fault,
                          "correct": line and line["correct"], "checks": line and line["checks"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
