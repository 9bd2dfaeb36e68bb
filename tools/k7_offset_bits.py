"""K7's whole-vocabulary launch (no column offset) from this tree's
`emoasr_tpu_torch/csrc/rnnt_joint.cu` against the same launch from another
source (`--csrc`, e.g. a checkout's csrc/ from before the vocabulary split
gave the kernel its column offset), on the same inputs: L4's largest
bucket, (18, 399, 129), J = 512, V = 1000, f32 and bf16, from numpy's
generator (`chip_smoke.k7_digest_inputs`).  Prints, per dtype, whether the
two outputs are bit-identical and each one's SHA-256 (lp_blank's bytes,
then lp_label's): `chip_smoke.K7_WHOLE_SHA256` holds the other source's,
which phase 3 of `chip_smoke.py` holds this tree's launch to.  Needs a CUDA
card and nvcc; builds into build/k7_offset_bits/.

Usage: python tools/k7_offset_bits.py --csrc DIR
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", required=True, help="the other source's csrc/ directory")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke
    from emoasr_tpu_torch.ops import cuda_lib, rnnt_joint

    if not torch.cuda.is_available():
        print("k7_offset_bits: CUDA is not available", file=sys.stderr)
        return 2
    other_dir = os.path.join(REPO, "build", "k7_offset_bits", "csrc")
    shutil.rmtree(other_dir, ignore_errors=True)
    shutil.copytree(os.path.abspath(args.csrc), other_dir)
    P, I, L = cuda_lib.P, cuda_lib.I, cuda_lib.L
    sigs = {f"emo_rnnt_joint_{s}": [P] * 8 + [I] * 6 + [L, L, I, I, P] for s in ("f32", "bf16")}
    other = cuda_lib.CudaKernel(os.path.relpath(os.path.join(other_dir, "rnnt_joint.cu"), cuda_lib.CSRC_DIR), sigs,
                                name="k7_offset_bits_other")
    cuda_lib.build_all([rnnt_joint.KERNEL, other])
    dev = torch.device("cuda", 0)
    mine = chip_smoke.k7_whole_digests(dev)
    shipped, rnnt_joint.KERNEL = rnnt_joint.KERNEL, other
    try:
        theirs = chip_smoke.k7_whole_digests(dev)
    finally:
        rnnt_joint.KERNEL = shipped
    print(chip_smoke.nvidia_smi_line())
    for dtype in mine:
        print(f"{dtype}: this tree {mine[dtype]}, --csrc {theirs[dtype]}: "
              f"{'bit-identical' if mine[dtype] == theirs[dtype] else 'DIFFERENT'}")
    print(json.dumps({"this_tree": mine, "other": theirs, "equal": mine == theirs}))
    return 0 if mine == theirs else 1


if __name__ == "__main__":
    sys.exit(main())
