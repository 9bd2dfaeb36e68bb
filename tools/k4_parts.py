"""Where K4's float32 launchers (the encoder attention,
`emoasr_tpu_torch/csrc/attention.cu`) spend their time on the card: each
launch kind beside variants of its own source with one part taken out,
timed at the largest L1 bucket, (18, 399, 4, 64), lens spread from 100 to
399 as `chip_smoke.py` spreads them.

  no_split         each split of an f32 operand into bf16 terms replaced by
                   one byte permute (the products stay, on wrong operands)
  one_product      only the leading product (hi x hi) of each split pair: the
                   products' count of the bf16 launchers
  no_products      every mma replaced by one integer operation on its operands
  no_split_launch  the backward's first launch (its operands' planes) left out
  no_pass1         the backward's pass 1 without its sweep over the keys
  no_pass2         the backward's pass 2 without its sweep over the queries
  bwd_rows32       the backward holding f32 rows, split as they are read, as
                   the D <= 128 instance does (D <= 64 holds bf16 planes)
  own_planes       the backward's own tiles (pass 1 Q and dO, pass 2 K and V)
                   as bf16 planes (with the bias one block an SM) instead of
                   f32 rows (two)

A variant's outputs are wrong by design; only its time is read.  The
kernel's time less a variant's is what that part costs where nothing else
hides it.  Needs a CUDA card and nvcc; builds into build/k4_parts/.

Usage: python tools/k4_parts.py [--iters 20] [--reps 2]
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
from emoasr_tpu_torch.ops import attention, cuda_lib  # noqa: E402
from emoasr_tpu_torch.utils.device import set_matmul_precision  # noqa: E402

SPLIT = "emo_mma::split_pack<kTerms>("
CHEAP_SPLIT = "cheap_pack("
CHEAP_DEF = ("__device__ __forceinline__ void cheap_pack(float x, float y, uint32_t t[3]) {\n"
             "  t[0] = t[1] = t[2] = __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);\n}\n\n"
             "// c += the leading cross products")
PRODUCTS = "  for (int order = kTerms - 1; order >= 0; --order)"
MMA = "emo_mma::mma(t, a[i], b[order - i][0], b[order - i][1]);"
NO_MMA = "t[0] += __uint_as_float(a[i][0] ^ b[order - i][0]);"
PASS1 = "  float s[8][4], dp[8][4], kf[8][4], acc[2 * KD][4];\n  zero_acc<KD>(acc);\n  for (int kt = 0; kt < n_kt; ++kt) {"
EDITS = {
    "kernel": [],
    "no_split": [(SPLIT, CHEAP_SPLIT), ("// c += the leading cross products", CHEAP_DEF)],
    "one_product": [(PRODUCTS, "  for (int order = 0; order >= 0; --order)")],
    "no_products": [(MMA, NO_MMA)],
    "no_split_launch": [("  if (!wide) split_kernel", "  if (false) split_kernel")],
    "no_pass1": [(PASS1, PASS1.replace("kt < n_kt", "kt < 0"))],
    "no_pass2": [("const int n_qt = cdiv(T_len, kBQ);", "const int n_qt = 0;")],
    "bwd_rows32": [("tc::launch_bwd_f32<4, tc::Planes, tc::RowsA32>", "tc::launch_bwd_f32<4, tc::Rows32, tc::Rows32>")],
    "own_planes": [("tc::launch_bwd_f32<4, tc::Planes, tc::RowsA32>", "tc::launch_bwd_f32<4, tc::Planes, tc::Planes>")],
}


def variant_kernels(out_dir: str) -> dict:
    """One CudaKernel per variant, its source edited from csrc/attention.cu."""
    with open(os.path.join(cuda_lib.CSRC_DIR, "attention.cu")) as f:
        src = f.read()
    os.makedirs(out_dir, exist_ok=True)
    for header in (f for f in os.listdir(cuda_lib.CSRC_DIR) if f.endswith(".cuh")):
        shutil.copy(os.path.join(cuda_lib.CSRC_DIR, header), out_dir)
    kernels = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"k4_parts: the source no longer holds the text that variant {name} edits")
            text = text.replace(old, new, 1 if old.startswith("//") else -1)
        path = os.path.join(out_dir, f"attention_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        kernels[name] = cuda_lib.CudaKernel(os.path.relpath(path, cuda_lib.CSRC_DIR), attention.KERNEL.signatures,
                                            name=f"k4_parts_{name}")
        kernels[name].counts.update({k: 0 for k in attention.KERNEL.counts})  # the wrapper's bias counts too
    return kernels


def cases(dev, gen, B=18, T=399, H=4, D=64):
    """The launch kinds as callables: the forward (decoding, and training's
    with dropout 0.1), with the bias, and the backward of both (dropout
    0.1)."""
    lens = torch.linspace(T // 4, T, B, device=dev).round().int()
    q, k, v, d_out = (torch.randn(B, T, H, D, generator=gen, device=dev) for _ in range(4))
    bias = torch.randn(B, H, T, T, generator=gen, device=dev) * D ** 0.5
    scale = 1.0 / D ** 0.5
    fsa = attention.fused_self_attention

    def fwd(rate, b=None):
        return lambda: fsa(q, k, v, lens, scale=scale, dropout_rate=rate, deterministic=rate == 0, seed=7, bias=b)

    def bwd(b=None):
        ins = [x.clone().requires_grad_(True) for x in (q, k, v)] + ([] if b is None else [b.clone().requires_grad_(True)])
        out = fsa(*ins[:3], lens, scale=scale, dropout_rate=0.1, deterministic=False, seed=7,
                  bias=None if b is None else ins[3])
        return chip_smoke._grad_timer(out, ins, d_out)

    return {"fwd": fwd(0.0), "fwd dropout": fwd(0.1), "bias fwd": fwd(0.0, bias), "bwd dropout": bwd,
            "bias bwd dropout": lambda: bwd(bias)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_parts: CUDA is not available", file=sys.stderr)
        return 2
    set_matmul_precision("float32")
    kernels = variant_kernels(os.path.join(REPO, "build", "k4_parts"))
    cuda_lib.build_all(kernels.values())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shipped = attention.KERNEL
    rows = {}

    def timed(label, make):
        fn = make() if label.split(" | ")[1].startswith(("bwd", "bias bwd")) else make
        ms = chip_smoke.cuda_time_ms(fn, iters=args.iters, warmup=2)
        rows.setdefault(label, []).append(ms)

    try:
        for _ in range(args.reps):  # in turns, so that a drift of the card shows as a spread
            for name, kernel in kernels.items():
                attention.KERNEL = kernel
                for case, make in cases(dev, gen).items():
                    timed(f"{name} | {case}", make)
    finally:
        attention.KERNEL = shipped
    for key, ms in rows.items():
        print(f"  {key}: {' / '.join(f'{x:.4f}' for x in ms)} ms")
    print(json.dumps({"card": chip_smoke.nvidia_smi_line(), "shape": "(18, 399, 4, 64) f32", "ms": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
