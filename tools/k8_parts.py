"""Where K8 (the LSTM recurrence, `emoasr_tpu_torch/csrc/lstm_scan.cu`)
spends its time on the card: the forward and the backward beside variants
of their own source with one part taken out, at the prediction network's
largest bucket (B = 18, T = 129) at H = 512 and 1024, in float32 and
bfloat16 (w_hh bf16 in the bf16 runs, as the bf16 training step hands it
over).

  no_products    every product replaced by one integer or float operation on
                 its operands
  no_split       the forward's A fragments take h_{t-1}'s staged f32 bits as
                 they are instead of splitting each value into two bf16
                 terms (the backward's d pre_t arrives split by the cell
                 that computes it): the most that such a split by the
                 producer, into words of the same bytes, could save the
                 forward
  no_broadcast   the per-step copies of h_{t-1} (forward) or d pre_t
                 (backward) from L2 left out (the products read stale data)
  no_cell        the cell update (forward) or the cells' backward left out
  barrier_only   the steps' work left out (the batch tiles' products and
                 cell updates, the backward's cells): T steps of the same
                 grid and their grid barriers, T x the card's step latency:
                 the latency floor

A variant's outputs are wrong by design; only its time is read.  The
kernel's time less a variant's is what that part costs where nothing else
hides it.  Needs a CUDA card and nvcc; builds into build/k8_parts/.

Usage: python tools/k8_parts.py [--iters 10] [--reps 2]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MMA = ("        mma(p0, a[mt][1], wk[nt][0], wk[nt][1]);\n"
       "        if (w1k != nullptr) mma(p1, a[mt][0], lo.x, lo.y);\n"
       "        mma(p2, a[mt][0], wk[nt][0], wk[nt][1]);")
NO_MMA = ("        p0[0] += __uint_as_float(a[mt][1][0] ^ wk[nt][0]);\n"
          "        if (w1k != nullptr) p1[1] += __uint_as_float(a[mt][0][1] ^ lo.x);\n"
          "        p2[2] += __uint_as_float(a[mt][0][2] ^ wk[nt][1]);")
COPY = "    cp_async16(slot + r * LD + 4 * v, x + static_cast<size_t>(r) * ldx + c0 + 4 * v, true);"
CELL_FWD = "      if (m < nb && j < H) {  // the cell update, a thread a cell"
CELL_BWD = "      if (live) {\n        const CellIn in ="
FWD_TILES = "    for (int b0 = 0; b0 < B; b0 += rows) {\n      const int nb = min(rows, B - b0);"
BWD_TILES = "    for (int b0 = 0; b0 < B; b0 += rows)\n      bwd_tile<KMAX, CK>("
NO_BWD_CELL = [(CELL_BWD, "      if (live && T < 0) {\n        const CellIn in ="),
               ("        if (live && !(j & 1)) {", "        if (live && !(j & 1) && T < 0) {")]
EDITS = {
    "kernel": [],
    "no_products": [(MMA, NO_MMA)],
    "no_split": [("    if (PLANES) {", "    if (true) {")],
    "no_broadcast": [(COPY, "")],
    "no_cell": [(CELL_FWD, "      if (m < nb && j < H && T < 0) {"), *NO_BWD_CELL],
    "barrier_only": [(FWD_TILES, FWD_TILES.replace("b0 < B;", "b0 < B && T < 0;")),
                     (BWD_TILES, BWD_TILES.replace("b0 < B;", "b0 < B && T < 0;")), *NO_BWD_CELL],
}


def variant_sources(src: str) -> dict:
    """{variant: edited source} of the K8 source; raises where an edit's
    text is missing."""
    out = {}
    for name, changes in EDITS.items():
        text = src
        for old, new in changes:
            if old not in text:
                raise SystemExit(f"k8_parts: the source no longer holds the text that variant {name} edits")
            text = text.replace(old, new)
        out[name] = text
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke
    from emoasr_tpu_torch.ops import cuda_lib, lstm_scan
    from emoasr_tpu_torch.utils.device import set_matmul_precision

    if not torch.cuda.is_available():
        print("k8_parts: CUDA is not available", file=sys.stderr)
        return 2
    set_matmul_precision("float32")
    with open(os.path.join(cuda_lib.CSRC_DIR, "lstm_scan.cu")) as f:
        src = f.read()
    out_dir = os.path.join(REPO, "build", "k8_parts")
    os.makedirs(out_dir, exist_ok=True)
    for header in (f for f in os.listdir(cuda_lib.CSRC_DIR) if f.endswith(".cuh")):
        shutil.copy(os.path.join(cuda_lib.CSRC_DIR, header), out_dir)
    kernels = {}
    for name, text in variant_sources(src).items():
        path = os.path.join(out_dir, f"lstm_scan_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        kernels[name] = cuda_lib.CudaKernel(os.path.relpath(path, cuda_lib.CSRC_DIR), lstm_scan.KERNEL.signatures,
                                            name=f"k8_parts_{name}")
    cuda_lib.build_all(kernels.values())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = {}
    for H in (512, 1024):
        base = chip_smoke.lstm_case(dev, gen, 18, 129, H)
        for dt in (torch.float32, torch.bfloat16):
            x_proj, w_hh, h0, c0 = (t.to(dt) for t in base[:4])
            cots = [c.to(dt) for c in base[4]]
            cases[f"H={H} {'bf16' if dt == torch.bfloat16 else 'f32'}"] = (x_proj, w_hh, h0, c0, cots)
    shipped = lstm_scan.KERNEL
    rows = {}
    try:
        for _ in range(args.reps):  # in turns, so that a drift of the card shows as a spread
            for name, kernel in kernels.items():
                lstm_scan.KERNEL = kernel
                for key, (x_proj, w_hh, h0, c0, cots) in cases.items():
                    with torch.no_grad():
                        fwd = chip_smoke.cuda_time_ms(lambda: lstm_scan.lstm_scan_fused(x_proj, w_hh, h0, c0),
                                                      iters=args.iters, warmup=2)
                    ins = [t.clone().requires_grad_(True) for t in (x_proj, w_hh, h0, c0)]
                    ys, (hT, cT) = lstm_scan.lstm_scan_fused(*ins)
                    bwd = chip_smoke.cuda_time_ms(chip_smoke._grad_timer((ys, hT, cT), ins, cots),
                                                  iters=args.iters, warmup=2)
                    rows.setdefault(f"{name} fwd {key}", []).append(fwd)
                    rows.setdefault(f"{name} bwd {key}", []).append(bwd)
    finally:
        lstm_scan.KERNEL = shipped
    for key, ms in rows.items():
        print(f"  {key}: {' / '.join(f'{x:.4f}' for x in ms)} ms")
    print(json.dumps({"card": chip_smoke.nvidia_smi_line(), "shape": "B 18, T 129", "ms": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
