"""Where K2 (the CTC alpha/beta lattice, `emoasr_tpu_torch/csrc/ctc_lattice.cu`)
spends its time on the card: the forward (alpha) and the backward (beta and
the gradient) beside variants of their own source with one part taken out,
at L1's largest bucket (T' = 399, B = 18, S = 257) and at a wider lattice
(T' = 1100, B = 18, S = 1025: two states a thread).

Variants of the shipped source (states in registers, one named barrier a
step):

  no_loads            the emissions (and, backward, alpha[t]) loaded ahead
                      are not reloaded: every step reuses the first ones
  no_transcendentals  lse3 as the largest of its three terms; the gradient
                      without its exponential
  no_barriers         the chain's named barrier left out (the warps' boundary
                      values are read unsynchronised)
  no_stores           alpha and the gradient not stored
  chain_only          no loads, no transcendentals, no stores: each step's
                      dependence alone (shuffles, the boundary exchange and
                      its barrier, a max): the latency floor

and of the source before the redesign (`--csrc` pointing at its csrc/: a
thread a state, rows double-buffered in shared memory):

  no_loads            lp (and, backward, alpha) read as constants
  no_transcendentals  as above
  no_barriers         the barriers inside the loop over T left out
  chain_only          the loop's barrier and shared-memory exchange alone

Each variant's forward runs on the same inputs; every backward takes the
shipped kernel's alpha and ll, so that its live rows are the same.  A
variant's outputs are wrong by design; only its time is read.  Needs a CUDA
card and nvcc; builds into build/k2_parts/.

Usage: python tools/k2_parts.py [--csrc DIR] [--iters 20] [--reps 2]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LSE = ("  return m + static_cast<double>(log1p_of(exp_of(static_cast<float>(lo - m)) +\n"
       "                                          exp_of(static_cast<float>(mid - m))));")
GRAD = "        if ((live >> i) & 1u) out[i] = g_b * exp_of(static_cast<float>(pa[d][i] + be[i] - ll_b));"
ALPHA_LOAD = "      if (t + D < xlen) load_states(pf[d], next, live);"
BETA_LOAD = ("      if (t - D >= 0) {\n"
             "        load_states(pl[d], next_lp, live);\n"
             "        load_states(pa[d], next_al, live);\n"
             "      }")
ALPHA_BAR = "      if (nwarps > 1) chain_barrier(nthreads);\n    }\n  }"
BETA_BAR = "      if (chain_warps > 1) chain_barrier(chain_threads);\n      // states s0 + SPL"
ALPHA_STORE = "      store();\n      publish(t & 1);"
GRAD_STORE = GRAD
NO_LOADS = [(ALPHA_LOAD, ""), (BETA_LOAD, "")]
NO_EXP = [(LSE, "  return fmax(m, mid + lo * 0.0);"), (GRAD, GRAD.replace("exp_of", ""))]
NO_STORES = [(ALPHA_STORE, "      publish(t & 1);"), (GRAD_STORE, "        (void)ll_b;")]
CURRENT = {
    "kernel": [],
    "no_loads": NO_LOADS,
    "no_transcendentals": NO_EXP,
    "no_barriers": [(ALPHA_BAR, ALPHA_BAR.replace("      if (nwarps > 1) chain_barrier(nthreads);\n", "")),
                    (BETA_BAR, BETA_BAR.replace("      if (chain_warps > 1) chain_barrier(chain_threads);\n", ""))],
    "no_stores": NO_STORES,
    "chain_only": [*NO_LOADS, (LSE, "  return fmax(m, mid + lo * 0.0);"), *NO_STORES],
}

OLD_ALPHA_STEP = "      const float a = lse3(a0, a1, a2) + lp_b[t * lp_st + s];"
OLD_BETA_D = "    for (int s = threadIdx.x; s < S; s += blockDim.x) dsh[s] = beta[s] + lp_b[(t + 1) * lp_st + s];"
OLD_GRAD = "      grad_b[t * lp_st + s] = g_b * expf(alpha[off + s] + be - ll_b);"
OLD_LSE = "  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));"
OLD_ALPHA_BAR = "    __syncthreads();\n    float* tmp = cur;"
OLD_BETA_BAR1 = "    __syncthreads();\n    const size_t off = t * step + row;"
OLD_BETA_BAR2 = "      grad_b[t * lp_st + s] = g_b * expf(alpha[off + s] + be - ll_b);\n    }\n    __syncthreads();"
OLD_ALPHA_REST = ("      nxt[s] = a;\n      alpha[off + s] = a;")
OLD_ALPHA_A2 = "      const float a2 = (s >= 2 && allow2[row + s] > 0.5f) ? cur[s - 2] : kLog0;"
OLD_BETA_D2 = "      const float d2 = (s + 2 < S && allow2[row + s + 2] > 0.5f) ? dsh[s + 2] : kLog0;"
BEFORE = {
    "kernel": [],
    "no_loads": [(OLD_ALPHA_STEP, "      const float a = lse3(a0, a1, a2) + 0.5f;"),
                 (OLD_BETA_D, OLD_BETA_D.replace("lp_b[(t + 1) * lp_st + s]", "0.5f")),
                 (OLD_GRAD, OLD_GRAD.replace("alpha[off + s]", "0.f"))],
    "no_transcendentals": [(OLD_LSE, "  return fmaxf(fmaxf(a, b), c);"), (OLD_GRAD, OLD_GRAD.replace("expf", ""))],
    "no_barriers": [(OLD_ALPHA_BAR, "    float* tmp = cur;"),
                    (OLD_BETA_BAR1, "    const size_t off = t * step + row;"),
                    (OLD_BETA_BAR2, OLD_BETA_BAR2.replace("\n    __syncthreads();", ""))],
    "chain_only": [(OLD_ALPHA_STEP, "      const float a = fmaxf(fmaxf(a0, a1), a2);"),
                   (OLD_ALPHA_REST, "      nxt[s] = a;"),
                   (OLD_ALPHA_A2, "      const float a2 = s >= 2 ? cur[s - 2] : kLog0;"),
                   (OLD_BETA_D, OLD_BETA_D.replace("lp_b[(t + 1) * lp_st + s]", "0.5f")),
                   (OLD_BETA_D2, "      const float d2 = s + 2 < S ? dsh[s + 2] : kLog0;"),
                   (OLD_LSE, "  return fmaxf(fmaxf(a, b), c);"),
                   (OLD_GRAD, "      (void)ll_b;")],
}
PROFILES = {"current": CURRENT, "before": BEFORE}


def edit(src: str, changes: list, what: str) -> str:
    for old, new in changes:
        if old not in src:
            raise SystemExit(f"k2_parts: the source no longer holds the text that variant {what} edits")
        src = src.replace(old, new)
    return src


def profile_of(src: str) -> str:
    """'current' for the shipped design, 'before' for the shared-memory
    one, by the text each one's variants edit."""
    for name, edits in PROFILES.items():
        if all(old in src for changes in edits.values() for old, _ in changes):
            return name
    raise SystemExit("k2_parts: the source matches neither known design")


def variant_sources(src: str) -> dict:
    """{variant: edited source} of a K2 source; raises where an edit's text
    is missing."""
    return {name: edit(src, changes, name) for name, changes in PROFILES[profile_of(src)].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=None, help="the csrc/ directory whose ctc_lattice.cu to take (default: this tree's)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke
    from emoasr_tpu_torch.ops import ctc_lattice, cuda_lib

    if not torch.cuda.is_available():
        print("k2_parts: CUDA is not available", file=sys.stderr)
        return 2
    csrc = os.path.abspath(args.csrc or cuda_lib.CSRC_DIR)
    with open(os.path.join(csrc, "ctc_lattice.cu")) as f:
        src = f.read()
    profile = profile_of(src)
    P, I, L = cuda_lib.P, cuda_lib.I, cuda_lib.L
    current = profile == "current"  # its launchers also take ll in float64 and the geometry
    sigs = {"emo_ctc_alpha_f32": [P] * (8 if current else 7) + [I] * 3 + [L, L] + [I, I] * current + [P],
            "emo_ctc_beta_grad_f32": [P] * 8 + [I] * 3 + [L, L] + [I, I] * current + [P]}
    out_dir = os.path.join(REPO, "build", "k2_parts", profile)
    os.makedirs(out_dir, exist_ok=True)
    kernels = {}
    for name, text in variant_sources(src).items():
        path = os.path.join(out_dir, f"ctc_lattice_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        kernels[name] = cuda_lib.CudaKernel(os.path.relpath(path, cuda_lib.CSRC_DIR), sigs,
                                            name=f"k2_parts_{profile}_{name}")
    cuda_lib.build_all(kernels.values())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    for B, T, U, V in ((18, 399, 128, 10000), (18, 1100, 512, 10000)):
        lp_path, allow2f, initf, finalf, xlens = chip_smoke.lattice_case(dev, gen, B, T, U, V)
        S = lp_path.shape[2]
        masks = [m.float().contiguous() for m in (allow2f, initf, finalf)]
        xl = xlens.int().contiguous()
        geo = ctc_lattice.launch_geometry(S)
        extra = (geo["spl"], geo["warps"]) if current else ()
        alpha = torch.empty(T, B, S, device=dev, dtype=torch.float64 if current else torch.float32)
        ll, ll64 = torch.empty(B, device=dev), torch.empty(B, device=dev, dtype=torch.float64)
        grad = torch.empty_strided(lp_path.shape, lp_path.stride(), device=dev)
        g = torch.ones(B, device=dev)
        st = (lp_path.stride(0), lp_path.stride(1))
        outs = (alpha, ll, ll64) if current else (alpha, ll)
        a_ptrs = (lp_path.data_ptr(), *(m.data_ptr() for m in masks), xl.data_ptr(), *(o.data_ptr() for o in outs))
        kernels["kernel"].lib().emo_ctc_alpha_f32(*a_ptrs, T, B, S, *st, *extra, stream)
        ok = [o.clone() for o in outs]  # the backward's inputs, from the shipped kernel
        ins = (ok[0], ok[2]) if current else tuple(ok)
        b_ptrs = (lp_path.data_ptr(), masks[0].data_ptr(), masks[2].data_ptr(), xl.data_ptr(),
                  *(o.data_ptr() for o in ins), g.data_ptr(), grad.data_ptr())
        cases.append((f"({T},{B},{S})", a_ptrs, b_ptrs, T, B, S, st, extra, geo, outs, ins, lp_path, grad))
    rows = {}

    def check(err, what):
        if err:
            raise RuntimeError(f"k2_parts {what}: cudaError {err}")

    for _ in range(args.reps):  # in turns, so that a drift of the card shows as a spread
        for name, kernel in kernels.items():
            lib = kernel.lib()
            for tag, a_ptrs, b_ptrs, T, B, S, st, extra, *_ in cases:
                fwd = chip_smoke.cuda_time_ms(lambda: check(lib.emo_ctc_alpha_f32(*a_ptrs, T, B, S, *st, *extra,
                                                                                   stream), f"{name} alpha"),
                                              iters=args.iters, warmup=2)
                bwd = chip_smoke.cuda_time_ms(lambda: check(lib.emo_ctc_beta_grad_f32(*b_ptrs, T, B, S, *st, *extra,
                                                                                       stream), f"{name} beta"),
                                              iters=args.iters, warmup=2)
                rows.setdefault(f"{name} alpha {tag}", []).append(fwd)
                rows.setdefault(f"{name} beta {tag}", []).append(bwd)
    for key, ms in rows.items():
        print(f"  {key}: {' / '.join(f'{x:.4f}' for x in ms)} ms")
    geos = {c[0]: c[8] for c in cases} if current else None
    print(json.dumps({"card": chip_smoke.nvidia_smi_line(), "profile": profile, "geometry": geos, "ms": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
