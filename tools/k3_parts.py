"""Where K3 (the beams' top-k, `emoasr_tpu_torch/csrc/topk.cu`) spends its
time on the card: the kernel beside variants of its own source with one
part taken out, at the main paths' shapes (B = 18): the CTC beam's
(18, 10000) k = 8, the attention pre-selection's (18, 10, 10000) and CSJ's
(18, 10, 10872) k = 15, the ALSD expansion's (18, 10, 999) k = 10 and the
W = 17 pool's (18, 289) k = 17, in float32 and bfloat16.

Variants of the shipped source (threshold select, rows split over a
cluster):

  no_load       the row's 16-byte loads replaced by words made from the
                thread's index (keys and masks as before)
  load_only     the row's load and key conversion, then nothing (the keys
                folded into one word so that the loads stay)
  no_rank       the candidates' ranks taken as their positions in the
                compacted list (no count against the others)
  no_merge      a split row's first block returns instead of merging the
                parts' lists (the cluster barriers stay)
  launch_only   an empty kernel of the same grid and cluster: the floor

and of the source before the redesign (`--csrc` pointing at its csrc/: one
block a row, the row in shared memory, k rounds of a block-wide max):

  no_load       the row's load and key conversion replaced by keys made
                from the index
  no_rescan     the winner's owner marks the entry and takes its next best
                without rescanning its entries
  no_rounds     the k rounds (their reductions, barriers and rescans) left out
  launch_only   an empty kernel of the same grid

A variant's outputs are wrong by design; only its time is read.  The
kernel's time less a variant's is what that part costs where nothing else
hides it.  `--phases` instead builds the shipped source with a clock64()
stamp at the end of each phase (load and thread maxima, warp sort, tau,
compaction, ranks, cluster barrier, merge), by thread 0 of every block,
and prints each phase's cycles, median and slowest block.  Needs a CUDA
card and nvcc; builds into build/k3_parts/.

Usage: python tools/k3_parts.py [--csrc DIR] [--iters 50] [--reps 2] [--phases]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = (((18, 10000), 8), ((18, 10, 10000), 15), ((18, 10, 10872), 15), ((18, 10, 999), 10),
          ((18, 289), 17))

LOAD = "    if (whole) word = __ldg(reinterpret_cast<const uint4*>(x + e0));"
AFTER_LOAD = "  const int i0 = static_cast<int>(q0 * EPW - base) + tid * EPW;  // row index of slot (0, 0)"
FOLD = ("  {  // keep the loads: fold the keys into one word\n"
        "    uint32_t acc = valid;\n"
        "#pragma unroll\n"
        "    for (int s = 0; s < KPT; ++s) acc ^= keys[s];\n"
        "    if (acc == 0x9E3779B9u) idx[0] = static_cast<int>(acc);\n"
        "    if (k > 0) return;\n"
        "  }\n")
RANK = "    for (int j = 0; j < n; ++j) r += cand[j] > w;"
KERNEL_TOP = "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n  const int row = blockIdx.x / parts"
CURRENT = {
    "kernel": [],
    "no_load": [(LOAD, "    if (whole) word = make_uint4(tid * 2654435761u, static_cast<uint32_t>(q), j * 40503u, ~tid);")],
    "load_only": [(AFTER_LOAD, FOLD + AFTER_LOAD)],
    "no_rank": [(RANK, "    r = c;")],
    "no_merge": [("  if (part != 0) return;", "  if (part >= 0) return;")],
    "launch_only": [(KERNEL_TOP, "  if (V > 0) return;\n" + KERNEL_TOP)],
}

OLD_LOAD = "    keys[i] = ordered_key(to_float(xr[i]));"
OLD_RESCAN = "      taken[j] = 1;\n      mine = local_best(keys, taken, V);"
OLD_ROUNDS = "  for (int r = 0; r < k; ++r) {"
OLD_TOP = "  const int row = blockIdx.x;\n  const T* xr ="
BEFORE = {
    "kernel": [],
    "no_load": [(OLD_LOAD, "    keys[i] = static_cast<uint32_t>(i) * 2654435761u;")],
    "no_rescan": [(OLD_RESCAN, "      taken[j] = 1;\n      mine = mine - 1;")],
    "no_rounds": [(OLD_ROUNDS, "  for (int r = 0; r < k && V < 0; ++r) {")],
    "launch_only": [(OLD_TOP, "  if (V > 0) return;\n" + OLD_TOP)],
}
# --phases: stamps after each phase, thread 0 of each block
STAMP = "  if (threadIdx.x == 0) emo_stamps[static_cast<size_t>(blockIdx.x) * 8 + {i}] = clock64();\n"
PHASES = ("load", "sort", "tau", "compact", "rank", "cluster", "merge")
STAMPED = [
    ("  if (parts > 1)  // every block of the cluster runs", STAMP.format(i=0) + "  if (parts > 1)  // every block of the cluster runs"),
    ("  const u64 sorted = warp_sort_desc(best, lane);", STAMP.format(i=1) + "  const u64 sorted = warp_sort_desc(best, lane);"),
    ("  u64 tau = 0;\n", "  u64 tau = 0;\n" + STAMP.format(i=2)),
    ("  // 3. compact the entries >= tau", STAMP.format(i=3) + "  // 3. compact the entries >= tau"),
    ("  const int n = min(n_cand, kMaxCand);", "  const int n = min(n_cand, kMaxCand);\n" + STAMP.format(i=4)),
    ("  if (parts == 1) return;", STAMP.format(i=5) + "  if (parts == 1) return;"),
    ("  if (part != 0) return;", STAMP.format(i=6) + "  if (part != 0) return;"),
]
STAMP_DECL = ("__device__ long long emo_stamps[1 << 17];\n\n"
              "// one block: slice `part` of row `row`")
STAMP_READ = ('extern "C" int emo_topk_read_stamps(void* dst, int n) {\n'
              '  return static_cast<int>(cudaMemcpyFromSymbol(dst, emo_stamps, sizeof(long long) * n));\n}\n')


def phase_source(src: str) -> str:
    """The shipped source with the stamps of `--phases`."""
    text = edit(src, [("// one block: slice `part` of row `row`", STAMP_DECL)] + STAMPED, "phases")
    # the merge's end: the kernel's closing brace
    end = "\n}\n\ntemplate <typename T, int WPT>\nint launch_wpt("
    text = edit(text, [(end, "\n" + STAMP.format(i=7) + end[1:])], "phases")
    return text + STAMP_READ


# the launchers' argument types: (x, vals, idx, rows, V, k[, parts, wpt], stream)
PROFILES = {"current": (CURRENT, 9), "before": (BEFORE, 7)}


def edit(src: str, changes: list, what: str) -> str:
    for old, new in changes:
        if old not in src:
            raise SystemExit(f"k3_parts: the source no longer holds the text that variant {what} edits")
        src = src.replace(old, new)
    return src


def profile_of(src: str) -> str:
    """'current' for the shipped design, 'before' for the shared-memory
    rounds, by the text each one's variants edit."""
    for name, (edits, _) in PROFILES.items():
        if all(old in src for changes in edits.values() for old, _ in changes):
            return name
    raise SystemExit("k3_parts: the source matches neither known design")


def variant_sources(src: str) -> dict:
    """{variant: edited source} of a K3 source; raises where an edit's text
    is missing."""
    edits = PROFILES[profile_of(src)][0]
    return {name: edit(src, changes, name) for name, changes in edits.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=None, help="the csrc/ directory whose topk.cu to take (default: this tree's)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--phases", action="store_true", help="per-phase cycles of the shipped source")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke
    from emoasr_tpu_torch.ops import cuda_lib, topk

    if not torch.cuda.is_available():
        print("k3_parts: CUDA is not available", file=sys.stderr)
        return 2
    csrc = os.path.abspath(args.csrc or cuda_lib.CSRC_DIR)
    with open(os.path.join(csrc, "topk.cu")) as f:
        src = f.read()
    profile = profile_of(src)
    n_args = PROFILES[profile][1]
    sig = [cuda_lib.P] * 3 + [cuda_lib.I] * (n_args - 4) + [cuda_lib.P]
    out_dir = os.path.join(REPO, "build", "k3_parts", profile)
    os.makedirs(out_dir, exist_ok=True)
    kernels = {}
    sources = {"phases": phase_source(src)} if args.phases else variant_sources(src)
    for name, text in sources.items():
        path = os.path.join(out_dir, f"topk_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        sigs = {"emo_topk_f32": sig, "emo_topk_bf16": sig}
        if args.phases:
            sigs["emo_topk_read_stamps"] = [cuda_lib.P, cuda_lib.I]
        kernels[name] = cuda_lib.CudaKernel(os.path.relpath(path, cuda_lib.CSRC_DIR), sigs,
                                            name=f"k3_parts_{profile}_{name}")
    cuda_lib.build_all(kernels.values())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    for shape, k in SHAPES:
        x32 = torch.log_softmax(torch.randn(*shape, generator=gen, device=dev), -1)
        for x in (x32, x32.to(torch.bfloat16)):
            V = shape[-1]
            rows = x.numel() // V
            geo = topk.launch_geometry(rows, V, k, x.dtype)
            vals = torch.empty(rows, k, dtype=x.dtype, device=dev)
            idx = torch.empty(rows, k, dtype=torch.int32, device=dev)
            extra = (geo["parts"], geo["wpt"]) if profile == "current" else ()
            tag = f"{tuple(shape)} k={k} {str(x.dtype).replace('torch.', '')}"
            cases.append((tag, x, vals, idx, rows, V, k, extra, geo))
    if args.phases:
        lib = kernels["phases"].lib()
        report = {}
        for tag, x, vals, idx, rows, V, k, extra, geo in cases:
            fn = getattr(lib, "emo_topk_bf16" if x.dtype == torch.bfloat16 else "emo_topk_f32")
            stream = torch.cuda.current_stream().cuda_stream
            for _ in range(3):  # warm, then the last launch's stamps
                fn(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, V, k, *extra, stream)
            torch.cuda.synchronize()
            blocks = geo["blocks"]
            buf = torch.empty(blocks * 8, dtype=torch.int64)
            lib.emo_topk_read_stamps(buf.data_ptr(), blocks * 8)
            st = buf.view(blocks, 8).double()
            out = {}
            last = 5 if geo["parts"] == 1 else 7
            for i in range(1, last + 1):
                d = st[:, i] - st[:, i - 1]
                if i == 7:  # the merge: first blocks only
                    d = d[:: geo["parts"]]
                out[PHASES[i - 1]] = [float(d.median()), float(d.max())]
            report[tag] = out
            print(f"  {tag} ({geo['parts']} blocks a row): " +
                  ", ".join(f"{p} {m:.0f}/{mx:.0f}" for p, (m, mx) in out.items()) + " cycles (median/slowest block)")
        print(json.dumps({"card": chip_smoke.nvidia_smi_line(), "phases_cycles": report}))
        return 0
    rows_ms = {}
    for _ in range(args.reps):  # in turns, so that a drift of the card shows as a spread
        for name, kernel in kernels.items():
            lib = kernel.lib()
            for tag, x, vals, idx, rows, V, k, extra, geo in cases:
                fn = getattr(lib, "emo_topk_bf16" if x.dtype == torch.bfloat16 else "emo_topk_f32")
                stream = torch.cuda.current_stream().cuda_stream

                def run():
                    err = fn(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, V, k, *extra, stream)
                    if err:
                        raise RuntimeError(f"k3_parts {name} {tag}: {lib.emo_error_string(err).decode()}")

                rows_ms.setdefault(f"{name} {tag}", []).append(chip_smoke.cuda_time_ms(run, iters=args.iters))
    for key, ms in rows_ms.items():
        print(f"  {key}: {' / '.join(f'{x:.4f}' for x in ms)} ms")
    geos = {tag: {k: geo[k] for k in ("parts", "wpt", "blocks")} for tag, *_, geo in cases} \
        if profile == "current" else None
    print(json.dumps({"card": chip_smoke.nvidia_smi_line(), "profile": profile, "geometry": geos, "ms": rows_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
