"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic and metrics come from
`BENCHMARK.json` and the data files beside this script; the run builds its
inputs and weights from `--seed`, warms up, measures for `--seconds`,
checks what the timed path produced against the plain reference and
prints one JSON line last on standard output: the cell's end-to-end
metrics (`--trace 0`) or its per-layer metrics (`--trace 1`).  It needs
as many CUDA devices as the cell asks for and refuses to run without them.
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

# the kernels' and the native loader's builds stay inside the checkout (the
# port fixes them under build/); what a library may cache goes to TMPDIR
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from harness import driver, spec

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    work = tempfile.mkdtemp(prefix="emoasr_bench_")
    try:
        line = driver.run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), work, T0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if line is None:
        return 1
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
