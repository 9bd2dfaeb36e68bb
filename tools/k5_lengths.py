"""K5 (the fused decoder-layer step, `emoasr_tpu_torch/csrc/decoder_step.cu`)
at encoder outputs longer than the L3 buckets': K5 and K5 indirect at Bu 18,
W 10, L 258, pos 64, D 256, F 2048, H 4, for each T' given (`elens` from T'/4
to T'), in float32 and bfloat16, beside the plain version and the dense route
(`chip_smoke.time_decoder_step`).  Beyond one window of the cross-attention
(512 frames in float32, 1024 in bf16) K5 takes each window's scores twice.

It times the checkout it is run from (its `chip_smoke.py` and kernels), so the
same file times another tree: `cd <other checkout> && python
<this checkout>/tools/k5_lengths.py`.  Needs a CUDA card and nvcc.

Usage: python tools/k5_lengths.py [--lengths 399 1100 2000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lengths", type=int, nargs="+", default=[399, 1100, 2000])
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke
    from emoasr_tpu_torch.utils.device import set_matmul_precision

    if not torch.cuda.is_available():
        print("k5_lengths: CUDA is not available", file=sys.stderr)
        return 2
    set_matmul_precision("float32")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    Bu, W = 18, 10
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        for T in args.lengths:
            lens = torch.linspace(T // 4, T, Bu, device=dev).round().int()
            for name, r in chip_smoke.time_decoder_step(dev, gen, Bu, W, 258, T, 64, lens, dt).items():
                rows[f"T={T} {name}"] = {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "dense_route_ms")}
                print(f"T={T} {name}: " + " ".join(f"{k} {v:.4f}" for k, v in rows[f"T={T} {name}"].items()),
                      flush=True)
    print(json.dumps({"card": chip_smoke.nvidia_smi_line(), "tree": os.getcwd(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
