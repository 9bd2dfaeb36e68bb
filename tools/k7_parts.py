"""Where K7 (the fused RNN-T joint, `emoasr_tpu_torch/csrc/rnnt_joint.cu`)
spends its time on the card: the kernel beside variants of its own source,
each with one part taken out, timed at the largest L4 bucket, (18, 399,
129) x (512, 1000), in bf16 and float32.

  no_z_build   z's build left out (the z tile keeps what shared memory holds)
  no_tanh      z = h_enc + h_dec, without the tanh
  no_products  every mma replaced by one integer operation on its operands
  no_w_copies  only the ring's first stages are copied
  no_epilogue  the bias, logsumexp, blank and label left out (the products
               kept alive by a sum)

A variant's outputs are wrong by design; only its time is read.  The
kernel's time less a variant's is what that part costs where nothing else
hides it.  Needs a CUDA card and nvcc; builds into build/k7_parts/.

Usage: python tools/k7_parts.py [--iters 10] [--reps 2]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from emoasr_tpu_torch.ops import cuda_lib, rnnt_joint  # noqa: E402
from emoasr_tpu_torch.utils.device import set_matmul_precision  # noqa: E402

MMA = ("                mma(acc[mt][2 * n2], af[p][mt], bq[0], bq[1]);\n"
       "                mma(acc[mt][2 * n2 + 1], af[p][mt], bq[2], bq[3]);")
NO_MMA = ("                acc[mt][2 * n2][0] += __uint_as_float(af[p][mt][0] ^ bq[0]);\n"
          "                acc[mt][2 * n2 + 1][0] += __uint_as_float(af[p][mt][1] ^ bq[2]);")
EPILOGUE = "    if (kc == n_kc - 1) {\n      // the V tile's logits"
KEEP_PRODUCTS = ("    if (kc == n_kc - 1) {\n#pragma unroll\n      for (int mt = 0; mt < MT; ++mt)\n#pragma unroll\n"
                 "        for (int j = 0; j < 8; ++j)\n"
                 "          run_l[mt][0] += acc[mt][j][0] + acc[mt][j][1] + acc[mt][j][2] + acc[mt][j][3];\n    }\n"
                 "    if (kc == n_kc - 1 && V < 0) {\n      // the V tile's logits")
EDITS = {
    "kernel": [],
    "no_z_build": [("  build_z<E, BM>(zs, ldz, he, hd, b, T, U1, J, m0, M, vec);", "")],
    "no_tanh": [("tanhf(", "(")],
    "no_products": [(MMA, NO_MMA)],
    "no_w_copies": [("    if (is_i < n_it) {", "    if (is_i < stages - 1) {")],
    "no_epilogue": [(EPILOGUE, KEEP_PRODUCTS)],
}


def variant_kernels(out_dir: str) -> dict:
    """One CudaKernel per variant, its source edited from csrc/rnnt_joint.cu."""
    with open(os.path.join(cuda_lib.CSRC_DIR, "rnnt_joint.cu")) as f:
        src = f.read()
    os.makedirs(out_dir, exist_ok=True)
    for header in (f for f in os.listdir(cuda_lib.CSRC_DIR) if f.endswith(".cuh")):
        shutil.copy(os.path.join(cuda_lib.CSRC_DIR, header), out_dir)
    kernels = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"k7_parts: the source no longer holds the text that variant {name} edits")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"rnnt_joint_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        kernels[name] = cuda_lib.CudaKernel(os.path.relpath(path, cuda_lib.CSRC_DIR), rnnt_joint.KERNEL.signatures,
                                            name=f"k7_parts_{name}")
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k7_parts: CUDA is not available", file=sys.stderr)
        return 2
    set_matmul_precision("float32")
    kernels = variant_kernels(os.path.join(REPO, "build", "k7_parts"))
    cuda_lib.build_all(kernels.values())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = {}
    for dt in (torch.bfloat16, torch.float32):
        h_enc, h_dec, weight, bias, labels = (x.to(dt) if x.is_floating_point() else x
                                              for x in chip_smoke.rnnt_joint_case(dev, gen, 18, 399, 129, 512, 1000))
        cases[dt] = (h_enc, h_dec, weight.t(), bias, labels)
    shipped = rnnt_joint.KERNEL
    rows = {}
    try:
        for _ in range(args.reps):  # in turns, so that a drift of the card shows as a spread
            for name, kernel in kernels.items():
                rnnt_joint.KERNEL = kernel
                for dt, case in cases.items():
                    with torch.no_grad():
                        ms = chip_smoke.cuda_time_ms(lambda: rnnt_joint.fused_joint_gather(*case, 0),
                                                     iters=args.iters, warmup=2)
                    rows.setdefault(f"{name} {'bf16' if dt == torch.bfloat16 else 'f32'}", []).append(ms)
    finally:
        rnnt_joint.KERNEL = shipped
    for key, ms in rows.items():
        print(f"  {key}: {' / '.join(f'{x:.3f}' for x in ms)} ms")
    print(json.dumps({"card": chip_smoke.nvidia_smi_line(), "shape": "(18, 399, 129) x (512, 1000)", "ms": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
