"""Where K5 (the fused decoder-layer step, `emoasr_tpu_torch/csrc/decoder_step.cu`,
direct and indirect) and K6 (the fused LM-layer step, `csrc/lm_step.cu`)
spend their time on the card: each kernel beside variants of its own
sources (the two `.cu` files and the `beam_step.cuh` they share) with one
part taken out, at the L3 decode shapes in float32 and bfloat16: K5 at
Bu 18, W 10, L 258, T 399, D 256, F 2048, H 4; K6 at Bu 18, W 10, L 256,
D 512, F 2048, H 8; every row at pos 64.

  no_products     the products' k-step streams left out (the weights' loads
                  from L2 and the mma; the epilogues stay, on stale sums)
  no_weight_loads the weights' loads left out (the mma take a register
                  pattern): what streaming the weights from L2 costs
  no_self_attn    the cached self-attention left out
  no_cross_attn   the cross-attention left out (K5)
  no_shares       the copies of a block's results into the other blocks'
                  shared memory (distributed shared memory) left out; the
                  cluster barriers stay
  no_layernorm    the LayerNorms left out
  barrier_only    the products (epilogues too), the attention and the
                  LayerNorms left out: the launch, the rows' load and the
                  cluster barriers, the latency floor

With --phases, the tool instead builds each kernel with a clock64() stamp
after every statement of its body (thread 0 of each block) and prints, for
one launch of each kernel, the cycles each statement took in the median and
the slowest block.

A variant's outputs are wrong by design; only its time is read.  The
kernel's time less a variant's is what that part costs where nothing else
hides it.  Needs a CUDA card and nvcc; builds into build/k5_parts/.

Usage: python tools/k5_parts.py [--iters 20] [--reps 2] [--out FILE] [--phases]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "emoasr_tpu_torch", "csrc")
SOURCES = ("beam_step.cuh", "decoder_step.cu", "lm_step.cu")

# (file, text, replacement): each part's loop made empty by a condition on
# a size that is never negative, or its work replaced by something cheaper
STREAM = [("beam_step.cuh", "    const int total = mine * Ls;", "    const int total = K < 0 ? mine * Ls : 0;")]
LOADS = [("beam_step.cuh", "r[t] = __ldg(lb + 32 * t);", "r[t] = make_uint4(lane, t, lk, K);")]
PRODUCTS = [("beam_step.cuh", "  for (int c0 = g0; c0 < g1; c0 += per_pass) {",
             "  for (int c0 = g0; c0 < g1 && K < 0; c0 += per_pass) {")]
SELF_ATTN = [("beam_step.cuh", "  for (int item = wg; item < rg.n * H; item += wtotal) {",
              "  for (int item = wg; item < rg.n * H && L < 0; item += wtotal) {")]
CROSS_ATTN = [("decoder_step.cu", "  for (int item = rank; item < nseg * H; item += csize) {",
               "  for (int item = rank; item < nseg * H && T < 0; item += csize) {")]
PEERS = "for (int peer = 1; peer < csize; ++peer)"
SHARES = [("beam_step.cuh", PEERS, "for (int peer = 1; peer < 1; ++peer)")]
LAYERNORM = [("beam_step.cuh", "  for (int w = first; w < rows; w += step) {",
              "  for (int w = first; w < rows && D < 0; w += step) {")]
EDITS = {
    "kernel": [],
    "no_products": STREAM,
    "no_weight_loads": LOADS,
    "no_self_attn": SELF_ATTN,
    "no_cross_attn": CROSS_ATTN,
    "no_shares": SHARES,
    "no_layernorm": LAYERNORM,
    "barrier_only": PRODUCTS + SELF_ATTN + CROSS_ATTN + LAYERNORM,
}


def variant_sources(sources: dict) -> dict:
    """{variant: {file: edited text}} of `sources` ({file: text} of
    SOURCES); raises where an edit's text is missing."""
    out = {}
    for name, changes in EDITS.items():
        texts = dict(sources)
        for path, old, new in changes:
            if old not in texts[path]:
                raise SystemExit(f"k5_parts: {path} no longer holds the text that variant {name} edits")
            texts[path] = texts[path].replace(old, new)
        out[name] = texts
    return out


TRACE_HEAD = """
#include <cuda_runtime.h>
__device__ unsigned long long emo_trace[1024 * 64];
__device__ unsigned long long emo_dtrace[1024 * 128];
__device__ int emo_dtrace_n[1024];
extern "C" int emo_trace_read(void* dst, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(dst, emo_trace, static_cast<size_t>(n) * 8);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(static_cast<char*>(dst) + n * 8, emo_dtrace, static_cast<size_t>(n) * 16);
  return static_cast<int>(e);
}
#define EMO_TRACE(i) if (threadIdx.x == 0 && (i) < 64) { emo_trace[blockIdx.x * 64 + (i)] = clock64(); if ((i) == 0) emo_dtrace_n[blockIdx.x] = 0; }
#define EMO_DTRACE() if (threadIdx.x == 0) { const int k_ = emo_dtrace_n[blockIdx.x]++; if (k_ < 128) emo_dtrace[blockIdx.x * 128 + k_] = clock64(); }
"""
# the stamps inside the products (each call: entry, B's first loads issued, the k-steps done, the epilogue done,
# the shares done), in order of the calls
DENSE_STAMPS = [
    ("  owned(N, rank, csize, g0, g1);\n", "  owned(N, rank, csize, g0, g1);\n  EMO_DTRACE();\n"),
    ("    float acc[NP][2][4];\n", "    EMO_DTRACE();\n    float acc[NP][2][4];\n"),
    ("    __syncthreads();\n    if ((threadIdx.x >> 5) < ncg) {", "    EMO_DTRACE();\n    __syncthreads();\n    if ((threadIdx.x >> 5) < ncg) {"),
    ("    __syncthreads();  // the next pass, or the next product, reuses the scratch\n  }\n",
     "    __syncthreads();  // the next pass, or the next product, reuses the scratch\n    EMO_DTRACE();\n  }\n"),
    ("  if (out_planes != nullptr)\n    share_rows(", "  EMO_DTRACE();\n  if (out_planes != nullptr)\n    share_rows("),
]


PHASES = ("cluster.sync", "dense<", "layer_norm(", "cached_attention", "cross_attention(", "zero_padding(",
          "__syncthreads();", "for (")


def traced_source(text: str) -> tuple:
    """(source, labels): `text` with a clock64() stamp at the start of the
    body of its __global__ kernel and after each of the body's statements
    that begins with one of PHASES (its phases)."""
    lines = text.split("\n")
    start = next(i for i, l in enumerate(lines) if "__global__" in l)
    body = next(i for i in range(start, len(lines)) if lines[i].split("//")[0].rstrip().endswith("{"))
    end = next(i for i in range(body + 1, len(lines)) if lines[i] == "}")
    out, labels, stmt, depth = lines[:body + 1] + ["  EMO_TRACE(0);"], ["start"], "", 0
    for l in lines[body + 1:end]:
        out.append(l)
        code = l.split("//")[0].strip()
        depth += code.count("{") - code.count("}") + code.count("(") - code.count(")")
        stmt = f"{stmt} {code}".strip()
        if depth == 0 and code.endswith((";", "}")):
            if stmt.startswith(PHASES):
                labels.append(stmt[:100])
                out.append(f"  EMO_TRACE({len(labels) - 1});")
            stmt = ""
    out += lines[end:]
    inc = next(i for i, l in enumerate(out) if l.startswith('#include "beam_step.cuh"'))
    return "\n".join(out[:inc] + [TRACE_HEAD] + out[inc:]), labels


# the stamps inside the cross-attention (after each chunk of keys staged, a
# window's scores, the row statistics, p, each chunk of values staged, the
# P V product), in order of the items
CROSS_STAMPS = [
    ("        stage(kb + static_cast<size_t>(c0) * D, fend - c0);\n",
     "        stage(kb + static_cast<size_t>(c0) * D, fend - c0);\n        EMO_DTRACE();\n"),
    ("      scores(f0);\n      const int n", "      scores(f0);\n      EMO_DTRACE();\n      const int n"),
    ("    if (nwin == 1) probs(0);", "    EMO_DTRACE();\n    if (nwin == 1) probs(0);"),
    ("    // P V: warp w takes", "    EMO_DTRACE();\n    // P V: warp w takes"),
    ("        stage(vb + static_cast<size_t>(c0) * D, fend - c0);\n",
     "        stage(vb + static_cast<size_t>(c0) * D, fend - c0);\n        EMO_DTRACE();\n"),
    ("    __syncthreads();\n    // and into the other blocks'", "    EMO_DTRACE();\n    __syncthreads();\n    // and into the other blocks'"),
]


def traced_header(text: str) -> str:
    """beam_step.cuh with DENSE_STAMPS (EMO_DTRACE as the traced sources define it)."""
    for old, new in DENSE_STAMPS:
        if old not in text:
            raise SystemExit("k5_parts: beam_step.cuh no longer holds the text the dense stamps go after")
        text = text.replace(old, new)
    return text


def read_sources() -> dict:
    out = {}
    for name in SOURCES:
        with open(os.path.join(CSRC, name)) as f:
            out[name] = f.read()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None, help="also write the result's JSON to this file")
    ap.add_argument("--phases", action="store_true", help="stamp the kernels' phases instead")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke
    from emoasr_tpu_torch.models.layers import TransformerDecoderLayer
    from emoasr_tpu_torch.models.lm.bert import BertLayer
    from emoasr_tpu_torch.ops import cuda_lib, decoder_step, lm_step
    from emoasr_tpu_torch.utils.device import set_matmul_precision

    if not torch.cuda.is_available():
        print("k5_parts: CUDA is not available", file=sys.stderr)
        return 2
    set_matmul_precision("float32")
    out_dir = os.path.join(REPO, "build", "k5_parts")
    shipped = (decoder_step.KERNEL, decoder_step.KERNEL_INDIRECT, lm_step.KERNEL)
    kernels, labels = {}, {}
    if not args.phases:
        variants = variant_sources(read_sources())
    else:
        src = read_sources()
        traced = {}
        for f in ("decoder_step.cu", "lm_step.cu"):
            traced[f], labels[f] = traced_source(src[f])
        for old, new in CROSS_STAMPS:
            if old not in traced["decoder_step.cu"]:
                raise SystemExit("k5_parts: decoder_step.cu no longer holds the text a cross-attention stamp goes at")
            traced["decoder_step.cu"] = traced["decoder_step.cu"].replace(old, new)
        variants = {"phases": {**src, **traced, "beam_step.cuh": traced_header(src["beam_step.cuh"])}}
    for name, texts in variants.items():
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        for f in os.listdir(cuda_lib.CSRC_DIR):  # the other headers, as they are
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(cuda_lib.CSRC_DIR, f), vdir)
        for f, text in texts.items():
            with open(os.path.join(vdir, f), "w") as fh:
                fh.write(text)
        extra = {"emo_trace_read": [cuda_lib.P, cuda_lib.I]} if args.phases else {}
        kernels[name] = tuple(
            cuda_lib.CudaKernel(os.path.join(vdir, k.source), {**k.signatures, **extra}, k.defines,
                                name=f"k5_parts_{name}_{k.name}")
            for k in shipped)
    cuda_lib.build_all(k for ks in kernels.values() for k in ks)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    Bu, W, T, pos = 18, 10, 399, 64
    lens = torch.linspace(T // 4, T, Bu, device=dev).round().int()
    cases = {}
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        c = chip_smoke._cast_case(chip_smoke.decoder_step_case(dev, gen, Bu, W, 258, T, 4, 256, 2048, pos=pos), dt)
        c["elens"] = lens
        c["pack"] = TransformerDecoderLayer(4, 256, 2048).to(dev, dt).eval()._packed_step_weights()
        lc = chip_smoke._cast_case(chip_smoke.lm_step_case(dev, gen, Bu, W, 256, 8, 512, 2048, pos=pos), dt)
        lc["pack"] = BertLayer(8, 512, 2048).to(dev, dt).eval()._packed_step_weights()
        cases[tag] = (c, lc)

    def calls(c, lc):
        N, dk = Bu * W, 64
        flat = lambda x: x.reshape(N, 258, 4, dk)
        tail = (c["cross_k"], c["cross_v"], c["elens"], c["pack"])
        return {
            "K5": lambda: decoder_step.fused_decoder_layer_step(
                c["h"], flat(c["cache_k"]), flat(c["cache_v"]), c["pos"].reshape(-1), *tail, beam_width=W),
            "K5 indirect": lambda: decoder_step.fused_decoder_layer_step_indirect(
                c["h"], c["cache_k"], c["cache_v"], c["pos"], c["anc"], *tail, beam_width=W),
            "K6": lambda: lm_step.fused_bert_layer_step_indirect(
                lc["h"], lc["cache_k"], lc["cache_v"], lc["pos"], lc["anc"], lc["pack"]),
        }

    if args.phases:
        return phases(kernels["phases"], labels, cases, calls, shipped, Bu, W)
    rows = {}
    try:
        with torch.no_grad():
            for _ in range(args.reps):  # in turns, so that a drift of the card shows as a spread
                for name, (k5, k5i, k6) in kernels.items():
                    decoder_step.KERNEL, decoder_step.KERNEL_INDIRECT, lm_step.KERNEL = k5, k5i, k6
                    for tag, (c, lc) in cases.items():
                        for what, fn in calls(c, lc).items():
                            ms = chip_smoke.cuda_time_ms(fn, iters=args.iters, warmup=3)
                            rows.setdefault(f"{name} {what} {tag}", []).append(ms)
    finally:
        decoder_step.KERNEL, decoder_step.KERNEL_INDIRECT, lm_step.KERNEL = shipped
    for key, ms in rows.items():
        print(f"  {key}: {' / '.join(f'{x:.4f}' for x in ms)} ms")
    result = {"card": chip_smoke.nvidia_smi_line(), "shape": "K5 Bu 18 W 10 L 258 T 399 D 256 F 2048 H 4; "
              "K6 Bu 18 W 10 L 256 D 512 F 2048 H 8; pos 64", "ms": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


def phases(traced, labels, cases, calls, shipped, Bu, W) -> int:
    """One launch of each traced kernel a dtype: the cycles of each phase,
    the median and the slowest of the launch's blocks."""
    import ctypes

    import numpy as np
    import torch

    import chip_smoke
    from emoasr_tpu_torch.ops import decoder_step, lm_step

    result = {}
    try:
        for tag, (c, lc) in cases.items():
            dt = c["h"].dtype
            decoder_step.KERNEL, decoder_step.KERNEL_INDIRECT, lm_step.KERNEL = traced
            for what, src, kernel, kind, D, F, H, T in (
                    ("K5 indirect", "decoder_step.cu", traced[1], "decoder", 256, 2048, 4, 399),
                    ("K6", "lm_step.cu", traced[2], "lm", 512, 2048, 8, 1)):
                fn = calls(c, lc)[what]
                with torch.no_grad():
                    for _ in range(3):
                        fn()
                    torch.cuda.synchronize()
                    fn()
                    torch.cuda.synchronize()
                blocks = decoder_step.device_geometry(kernel, kind, Bu, W, D, F, H, 258, T, dt, c["h"].device,
                                                      "k5_parts")["blocks"]
                buf = (ctypes.c_uint64 * (1024 * 64 * 3))()
                kernel.launch("emo_trace_read", ctypes.cast(buf, ctypes.c_void_p), 1024 * 64)
                allw = np.frombuffer(buf, dtype=np.uint64)
                stamps = allw[:1024 * 64].reshape(1024, 64)[:blocks, :len(labels[src])]
                slow = int(np.argmax(stamps[:, -1].astype(np.int64) - stamps[:, 0].astype(np.int64)))
                for b in sorted({0, slow}):
                    dst = allw[1024 * 64:].reshape(1024, 128)[b].astype(np.int64)  # the inner stamps
                    dst = dst[dst > 0]
                    print(f"  block {b}'s inner stamps (products: entry, loads issued, k-steps, epilogue, shares, "
                          f"passes repeat the middle three; cross-attention items: keys staged, scores, row statistics, "
                          f"p, values staged, P V): {np.diff(dst).tolist()}")
                cycles = np.diff(stamps.astype(np.int64), axis=1)
                key = f"{what} {tag}"
                result[key] = []
                print(f"{key}: {blocks} blocks, total median {int(np.median(cycles.sum(1)))} cycles")
                for i, label in enumerate(labels[src][1:]):
                    med, top = int(np.median(cycles[:, i])), int(cycles[:, i].max())
                    result[key].append([label, med, top])
                    print(f"  {med:>8} {top:>8}  {label[:80]}")
    finally:
        decoder_step.KERNEL, decoder_step.KERNEL_INDIRECT, lm_step.KERNEL = shipped
    print(json.dumps({"card": chip_smoke.nvidia_smi_line(), "cycles": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
