"""The arithmetic of the tensor-core kernels, emulated in PyTorch on the CPU.

K1 (`csrc/ctc_head.cu`) runs every product on bf16 tensor cores with
float32 sums.  Where an operand is float32 it is split into bf16 terms and
several products add into one float32 sum: in bf16, the backward's d logits
`gl` as hi = bf16(gl) and lo = bf16(gl - hi); in float32, every operand as
three terms, keeping the six leading cross products (terms i + j <= 2).
`_emulate_k1` computes exactly those products (a product of two bf16 values
is exact in float32) in PyTorch, with the kernels' split of the work: the
g_xs terms of grad-e enter as their own product with the rows of w
gathered by z, those of grad-w are added into gl (summed per label) before
it is split.  It
is held against `ctc_head_plain` under autograd and against the JAX
package's `fused_ctc_head` (Pallas, interpret mode, as the JAX tests run
it), at an L1-like width (H = 256, V = 10000, small B and T), within the
tolerances `chip_smoke.py` holds the kernels to on the card: so the split
design is tested before any chip time.

The launch geometry of K1 lives in Python (`ops/ctc_head.py::
launch_geometry`: the splits of V, the row groups of grad-w, the scratch
and the shared memory of each kernel): every shipped
ASR configuration's (T', H, V, S) must fit the 232,448 bytes of shared
memory a block may take, in both dtypes.
"""

import glob
import math
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import chip_smoke
from emoasr_tpu.ops import ctc as jctc
from emoasr_tpu.ops.ctc_head_pallas import fused_ctc_head as jax_head
from emoasr_tpu_torch.config import load_config
from emoasr_tpu_torch.ops import ctc_head

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float32": (torch.float32, jnp.float32)}


def _split(x: torch.Tensor, n: int) -> list:
    """x (float32) as n bf16 terms, each kept as float32, largest first."""
    terms = []
    for _ in range(n):
        t = x.to(torch.bfloat16).float()
        terms.append(t)
        x = x - t
    return terms


def _products(a_terms: list, b_terms: list, fn) -> torch.Tensor:
    """The sum of fn(a_i, b_j) over the leading cross products i + j <= 2."""
    return sum(fn(a, b) for i, a in enumerate(a_terms) for j, b in enumerate(b_terms) if i + j <= 2)


def _emulate_k1(e, w, b, z, g_lse, g_xs):
    """(lse, xs, d e, d w, d b) as the K1 kernels compute them, for e (B, T,
    H), w (H, V), b (V,) of one dtype; z (B, S) with labels in [0, V)."""
    bf16 = e.dtype == torch.bfloat16
    n_in, n_gl = (1, 2) if bf16 else (3, 3)
    E, W = _split(e.float(), n_in), _split(w.float(), n_in)
    logits = _products(E, W, lambda x, y: x @ y) + b.float()
    lse = torch.logsumexp(logits, -1)
    idx = z.long()[:, None, :].expand(-1, e.shape[1], -1)
    xs = torch.gather(logits, 2, idx)
    gl_p = g_lse[:, :, None] * torch.exp(logits - lse[:, :, None])
    # grad-e: the softmax term times w, then g_xs times w's columns gathered by z
    w_z = [torch.stack([t[:, zb.long()] for zb in z]) for t in W]  # (B, H, S) each
    d_e = _products(_split(gl_p, n_gl), W, lambda g, x: g @ x.t()) \
        + _products(_split(g_xs, n_gl), w_z, lambda g, x: g @ x.transpose(1, 2))
    # grad-w: the path terms added into d logits, then split
    gl = gl_p.scatter_add(2, idx, g_xs)
    flat = lambda t: t.reshape(-1, t.shape[-1])
    d_w = _products(_split(gl, n_gl), E, lambda g, x: flat(x).t() @ flat(g))
    d_b = gl.sum((0, 1))
    dt = e.dtype
    return lse, xs, d_e.to(dt), d_w.to(dt), d_b.to(dt)


def _case(seed, B=2, Tn=24, H=256, V=10000, U=6):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(B, Tn, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) / math.sqrt(H)).astype(np.float32)
    b = (rng.normal(size=(V,)) * 0.1).astype(np.float32)
    ys = rng.integers(1, V, size=(B, U)).astype(np.int32)
    ys[0, :3] = 7  # repeats
    ys[1, 4:] = 2  # eos padding
    z = np.array(jctc._extend_with_blanks(jnp.asarray(ys), 0))
    g_lse = rng.normal(size=(B, Tn)).astype(np.float32)
    g_xs = rng.normal(size=(B, Tn, z.shape[1])).astype(np.float32)
    return e, w, b, z, g_lse, g_xs


def _round(x: np.ndarray, dtype: str) -> np.ndarray:
    return x.astype(ml_dtypes.bfloat16).astype(np.float32) if dtype == "bfloat16" else x


def _jax_k1(e, w, b, z, g_lse, g_xs, jdt):
    S = z.shape[1]

    def f(e_, w_, b_):
        lse, xs = jax_head(e_, w_, b_, jnp.asarray(z))
        return lse, xs[:, :, :S]

    (lse, xs), vjp = jax.vjp(f, *(jnp.asarray(x).astype(jdt) for x in (e, w, b)))
    grads = vjp((jnp.asarray(g_lse), jnp.asarray(g_xs)))
    return [torch.from_numpy(np.array(x.astype(jnp.float32))) for x in (lse, xs, *grads)]


def _hold(got, want, dtype, z, name):
    """The card's tolerances (`chip_smoke.py`): lse and xs (float32) within
    atol 1e-4 + rtol 1e-4 of the largest entry; the gradients in f32 the
    same (d e), by vocabulary column (d w) and by group (d b); in bf16 one
    bf16 step of each entry plus a floor."""
    lse, xs, d_e, d_w, d_b = got
    V = d_w.shape[1]
    groups = chip_smoke._vocab_groups(V, torch.from_numpy(z))
    for what, a, c in (("lse", lse, want[0]), ("xs", xs, want[1])):
        chip_smoke._require_close(f"{name} {what}", a.float(), c.float(), *chip_smoke.HEAD_TOL)
    if dtype == "float32":
        chip_smoke._require_close(f"{name} d e", d_e, want[2].float(), *chip_smoke.HEAD_TOL)
        chip_smoke._require_close_by_column(f"{name} d w", d_w, want[3].float(), 1, *chip_smoke.HEAD_COLUMN_TOL)
        chip_smoke._require_close_by_group(f"{name} d b", d_b, want[4].float(), groups, *chip_smoke.HEAD_COLUMN_TOL)
    else:
        want = [x.to(torch.bfloat16) for x in want]
        chip_smoke._require_close_bf16(f"{name} d e", d_e, want[2], floor=chip_smoke.HEAD_TOL[1])
        chip_smoke._require_close_bf16(f"{name} d w", d_w, want[3], floor=chip_smoke.HEAD_COLUMN_TOL[1], col_dim=1)
        for g, idx in groups.items():
            if idx.numel():
                chip_smoke._require_close_bf16(f"{name} d b ({g})", d_b[idx], want[4][idx],
                                               floor=chip_smoke.HEAD_COLUMN_TOL[1])


@pytest.mark.parametrize("cotangent", ["independent", "ctc"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k1_split_products_match_plain(dtype, cotangent):
    """The emulated kernels against `ctc_head_plain` under autograd (the
    CPU route), with independent cotangents and with the CTC loss's
    g_lse = -sum_s g_xs, under which the two terms of d logits cancel."""
    e, w, b, z, g_lse, g_xs = _case(1 if dtype == "bfloat16" else 2)
    if cotangent == "ctc":
        g_lse = -g_xs.sum(-1)
    tdt = DTYPES[dtype][0]
    e, w, b = (torch.from_numpy(_round(x, dtype)).to(tdt) for x in (e, w, b))
    g_lse, g_xs, zt = torch.from_numpy(g_lse), torch.from_numpy(g_xs), torch.from_numpy(z)
    got = _emulate_k1(e, w, b, zt, g_lse, g_xs)
    ins = [x.clone().requires_grad_(True) for x in (e, w, b)]
    lse, xs = ctc_head.ctc_head_plain(*ins, zt)
    want = [lse.detach(), xs.detach(), *torch.autograd.grad((lse, xs), ins, (g_lse, g_xs))]
    _hold(got, [x.float() for x in want], dtype, z, f"K1 {dtype} {cotangent}, emulated vs plain")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k1_split_products_match_jax(dtype):
    """The emulated kernels against the JAX package's fused head (Pallas,
    interpret mode) on the same numpy-seeded inputs."""
    e, w, b, z, g_lse, g_xs = _case(3)
    e, w, b = (_round(x, dtype) for x in (e, w, b))
    want = _jax_k1(e, w, b, z, g_lse, g_xs, DTYPES[dtype][1])
    tdt = DTYPES[dtype][0]
    got = _emulate_k1(*(torch.from_numpy(x).to(tdt) for x in (e, w, b)), torch.from_numpy(z),
                      torch.from_numpy(g_lse), torch.from_numpy(g_xs))
    _hold(got, want, dtype, z, f"K1 {dtype}, emulated vs JAX")


def test_k1_split_is_needed():
    """The same bf16 backward with gl rounded once to bf16 (no lo term)
    misses the plain version's d w by more than the tolerance: the split
    carries the f32 operand, not the tolerance."""
    e, w, b, z, g_lse, g_xs = _case(4)
    e, w, b = (torch.from_numpy(_round(x, "bfloat16")).to(torch.bfloat16) for x in (e, w, b))
    zt, g_lse, g_xs = torch.from_numpy(z), torch.from_numpy(g_lse), torch.from_numpy(g_xs)
    logits = e.float() @ w.float() + b.float()
    lse = torch.logsumexp(logits, -1)
    idx = zt.long()[:, None, :].expand(-1, e.shape[1], -1)
    gl = (g_lse[:, :, None] * torch.exp(logits - lse[:, :, None])).scatter_add(2, idx, g_xs)
    rounded = (e.float().reshape(-1, e.shape[-1]).t() @ gl.to(torch.bfloat16).float().reshape(-1, gl.shape[-1]))
    ins = [x.clone().requires_grad_(True) for x in (e, w, b)]
    out = ctc_head.ctc_head_plain(*ins, zt)
    d_w = torch.autograd.grad(out, ins[1], (g_lse, g_xs))[0]
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke._require_close_by_column("d w, gl rounded once", rounded, d_w.float(), 1,
                                            *chip_smoke.HEAD_COLUMN_TOL)


def _asr_configs():
    """(name, T', H, V, S) of every shipped ASR configuration with a CTC or
    joint-CTC head: T' the largest bucket's frames after the 4x
    subsampling, S = 2 max tokens + 1."""
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "*", "*.yaml"))):
        if os.sep + "lm" + os.sep in path:
            continue
        cfg = load_config(path)
        if not getattr(cfg, "vocab_size", 0) or not getattr(cfg, "enc_hidden_size", 0):
            continue
        frames, tokens = max(cfg.buckets)
        T2 = ((frames - 1) // 2 - 1) // 2
        out.append((os.path.relpath(path, REPO), T2, cfg.enc_hidden_size, cfg.vocab_size, 2 * tokens + 1))
    return out


ASR_CONFIGS = _asr_configs()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name,T2,H,V,S", ASR_CONFIGS, ids=[c[0] for c in ASR_CONFIGS])
def test_k1_launch_geometry_fits_shipped_configs(name, T2, H, V, S, dtype):
    """Each kernel's shared memory within the 232,448 bytes of one block on
    sm_90 (two blocks a SM in bf16 where H fits one chunk), grids within
    CUDA's limits, splits of V (forward, grad-e) between 1 and the V tiles
    and row groups (grad-w) between 1 and the row tiles, scratch below one
    GB, at the largest bucket of a full batch (B = 18)."""
    tdt = DTYPES[dtype][0]
    H8 = -(-H // 8) * 8
    geo = ctc_head.launch_geometry(18, T2, H8, V, S, tdt)
    for kind in ctc_head.KINDS:
        g = geo[kind]
        assert g["smem"] <= ctc_head.MAX_SMEM, (name, kind, g)
        assert g["grid"][1] < 65536 and g["grid"][2] < 65536 and min(g["grid"]) >= 1
        assert 4 * g["scratch"] + 2 * g["planes"] < 2 ** 30
        assert (g["planes"] > 0) == (dtype == "float32")
    if dtype == "bfloat16" and H8 <= ctc_head.CHUNK[tdt]:
        assert 2 * geo["fwd"]["smem"] <= 228 * 1024  # two resident blocks a SM
    v_tiles = math.ceil(V / ctc_head.TILE)
    assert 1 <= geo["fwd"]["splits"] <= v_tiles and 1 <= geo["grad_e"]["splits"] <= v_tiles
    assert 1 <= geo["grad_w"]["splits"] <= 18 * math.ceil(T2 / ctc_head.TILE)
