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

K4's float32 launchers (`csrc/attention.cu`) split every operand of the
attention's products (q k^T, P V, dO V^T, dS K, dS^T q, Pd^T dO; P, Pd and
dS included) into three bf16 terms and keep the six leading cross
products, as K1 does: `_emulate_k4` holds that against the plain version
and the JAX kernel within the card's tolerances (forward 1e-5, backward and
d bias 1e-4), and shows that two terms miss the forward's.

K8's arithmetic is emulated in `test_torch_lstm_arith.py` (split from
this file so that two workers share the load).

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
import emoasr_tpu.ops.attention_pallas as jap
import emoasr_tpu.ops.rnnt_pallas as jrp
from emoasr_tpu_torch.config import load_config
from emoasr_tpu_torch.data.batching import derive_buckets
from emoasr_tpu_torch.ops import attention, ctc_head, rnnt_joint
from test_torch_bf16 import _hash_keep

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


# ---------------------------------------------------------------- K7

def _k7_from_z(z, w, b, labels, blank, terms):
    """(lp_blank, lp_label) of z (B, T, U+1, J) as float32 values of the
    kernel's dtype: z and w (J, V) as `terms` bf16 terms each, the leading
    cross products (i + j < terms) summed in float32, the float32 bias
    added, the logsumexp and the two columns taken in float32; a label
    outside [0, V) selects nothing (logit 0)."""
    Z, W = _split(z.float(), terms), _split(w.float(), terms)
    logits = sum(a @ c for i, a in enumerate(Z) for j, c in enumerate(W) if i + j < terms) + b.float()
    lse = torch.logsumexp(logits, -1)
    V, U = logits.shape[-1], labels.shape[1]
    lab = labels.long()[:, None, :, None].expand(-1, logits.shape[1], -1, 1)
    ok = (lab >= 0) & (lab < V)
    lab_logit = torch.where(ok, torch.gather(logits[:, :, :U], 3, lab.clamp(0, V - 1)), torch.zeros(()))[..., 0]
    return logits[..., blank] - lse, lab_logit - lse[:, :, :U]


def _emulate_k7(h_enc, h_dec, w, b, labels, blank=0, terms=None):
    """(lp_blank, lp_label) as K7 computes them: h_dec and w in h_enc's
    dtype, z = tanh(h_enc + h_dec) in that dtype (bf16: the sum rounded,
    then the tanh), then the products of one bf16 term each (bf16) or two
    (float32, the three products hi hi, lo hi, hi lo), `_k7_from_z`."""
    dt = h_enc.dtype
    z = torch.tanh(h_enc[:, :, None, :] + h_dec.to(dt)[:, None, :, :])
    return _k7_from_z(z, w.to(dt), b, labels, blank, terms or rnnt_joint.TERMS[dt])


def _k7_case(seed, J, V, B=2, T=5, U1=7):
    """The shapes and scales of `chip_smoke.rnnt_joint_case`, from numpy:
    w (J, V) as the `.t()` of a (V, J) layer, labels with eos padding, one
    label out of range."""
    rng = np.random.default_rng(seed)
    h_enc = rng.normal(size=(B, T, J)).astype(np.float32)
    h_dec = rng.normal(size=(B, U1, J)).astype(np.float32)
    w = (rng.normal(size=(J, V)) / math.sqrt(J)).astype(np.float32)
    b = (0.1 * rng.normal(size=(V,))).astype(np.float32)
    labels = rng.integers(1, V, size=(B, U1 - 1)).astype(np.int32)
    labels[:, (U1 - 1) // 2:] = 2
    return h_enc, h_dec, w, b, labels


def _hold_k7(got, want, name, tol=None):
    tol = chip_smoke.RNNT_JOINT_TOL if tol is None else tol
    return max(chip_smoke._require_close(f"{name} {what}", a.float(), c.float(), tol, 0.0)
               for what, a, c in zip(("lp_blank", "lp_label"), got, want))


K7_SHAPES = [(512, 1000), (512, 4000), (1024, 1000), (1024, 4000)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("J,V", K7_SHAPES)
def test_k7_split_products_match_plain(J, V, dtype):
    """The emulated kernel against `rnnt_joint_plain` (float32 products of
    the inputs' values), within RNNT_JOINT_TOL; in float32 with half the
    tolerance to spare (the two-term split is ~2^-17 of each product)."""
    tdt = DTYPES[dtype][0]
    h_enc, h_dec, w, b, labels = (torch.from_numpy(x) for x in _k7_case(J + V, J, V))
    h_enc, h_dec, w = h_enc.to(tdt), h_dec.to(tdt), w.to(tdt)
    got = _emulate_k7(h_enc, h_dec, w, b, labels)
    want = rnnt_joint.rnnt_joint_plain(h_enc, h_dec, w, b, labels, 0)
    err = _hold_k7(got, want, f"K7 {dtype} J={J} V={V}, emulated vs plain")
    if dtype == "float32":
        assert err < chip_smoke.RNNT_JOINT_TOL / 2, err


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("J,V", [(512, 4000), (1024, 1000)])
def test_k7_split_products_match_jax(J, V, dtype):
    """The emulated kernel against the JAX package's `fused_joint_gather_fwd`
    (Pallas, interpret mode) on the same numpy-seeded inputs, within
    RNNT_JOINT_TOL.  In bf16 the two frameworks' tanh may round a z to
    neighbouring bf16 values (XLA's CPU tanh is its own approximation), which
    moves a logit by up to ~5e-4: the products are held from XLA's own z,
    and the two z within one bf16 step of each other in a few elements."""
    h_enc, h_dec, w, b, labels = _k7_case(J * V + 1, J, V)
    tdt, jdt = DTYPES[dtype]
    jin = [jnp.asarray(x).astype(jdt) for x in (h_enc, h_dec, w)]
    want = jrp.fused_joint_gather_fwd(*jin, jnp.asarray(b), jnp.asarray(labels), blank_id=0)
    want = [torch.from_numpy(np.array(x)) for x in want]
    h_enc, h_dec, w, b, labels = (torch.from_numpy(x) for x in (h_enc, h_dec, w, b, labels))
    if dtype == "float32":
        got = _emulate_k7(h_enc, h_dec, w, b, labels)
    else:
        z_jax = torch.from_numpy(np.array(jnp.tanh(jin[0][:, :, None, :] + jin[1][:, None, :, :]).astype(jnp.float32)))
        z_port = torch.tanh(h_enc.to(tdt)[:, :, None, :] + h_dec.to(tdt)[:, None, :, :]).float()
        step = (z_port - z_jax).abs() / z_port.abs().clamp_min(2.0 ** -126)
        assert step.max() <= 2.0 ** -7 and (z_port != z_jax).float().mean() < 0.01
        got = _k7_from_z(z_jax, w.to(tdt), b, labels, 0, 1)
    _hold_k7(got, want, f"K7 {dtype} J={J} V={V}, emulated vs JAX")


def test_k7_split_is_needed():
    """In float32, z and w rounded once to bf16 (one term, one product)
    miss the plain version by more than RNNT_JOINT_TOL: the second term
    carries the float32 operand, not the tolerance."""
    h_enc, h_dec, w, b, labels = (torch.from_numpy(x) for x in _k7_case(7, 512, 1000))
    want = rnnt_joint.rnnt_joint_plain(h_enc, h_dec, w, b, labels, 0)
    with pytest.raises(chip_smoke.CheckFailed):
        _hold_k7(_emulate_k7(h_enc, h_dec, w, b, labels, terms=1), want, "K7 f32 rounded once")


def _transducer_configs():
    """(name, B, T', U+1, J, V) of every shipped transducer configuration
    at its largest bucket and a full batch: T' the frames after the 4x
    subsampling, J the joint width (`joint_hidden_size`, else the
    prediction network's)."""
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "*", "*.yaml"))):
        if os.sep + "lm" + os.sep in path:
            continue
        cfg = load_config(path)
        if getattr(cfg, "decoder_type", None) != "rnn_transducer":
            continue
        buckets = derive_buckets(cfg.buckets, cfg.max_xlens_batch, cfg.max_ylens_batch, cfg.batch_size)
        big = max(buckets, key=lambda x: x.max_xlen)
        T2 = ((big.max_xlen - 1) // 2 - 1) // 2
        J = cfg.joint_hidden_size or cfg.dec_hidden_size
        out.append((os.path.relpath(path, REPO), big.batch_size, T2, big.max_ylen + 1, J, cfg.vocab_size))
    return out


TRANSDUCER_CONFIGS = _transducer_configs()
WIDE_JOINTS = [(f"J={J}", 18, 399, 129, J, 4000) for J in (1024, 1500, 2048, 2794)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name,B,T2,U1,J,V", TRANSDUCER_CONFIGS + WIDE_JOINTS,
                         ids=[c[0] for c in TRANSDUCER_CONFIGS + WIDE_JOINTS])
def test_k7_launch_geometry_fits_shipped_configs(name, B, T2, U1, J, V, dtype):
    """A block's shared memory within the 232,448 bytes of sm_90, with two
    to four ring stages; the grid within CUDA's limits; 128 cells a block
    at J = 512 in bf16; the f32 split's scratch; and J = 2800 refused."""
    tdt = DTYPES[dtype][0]
    geo = rnnt_joint.launch_geometry(B, T2, U1, J, V, tdt)
    assert geo is not None, name
    assert geo["smem"] == rnnt_joint.smem_bytes(rnnt_joint.TERMS[tdt], geo["cells"], geo["stages"], J)
    assert geo["smem"] <= rnnt_joint.MAX_SMEM and 2 <= geo["stages"] <= 4
    assert geo["cells"] in rnnt_joint.CELLS[tdt] and geo["threads"] in (128, 256)
    assert 1 <= geo["grid"][0] < 2 ** 31 and 1 <= geo["grid"][1] < 65536
    assert geo["grid"][0] * geo["cells"] >= T2 * U1 > (geo["grid"][0] - 1) * geo["cells"]
    assert geo["planes"] == (2 * V * math.ceil(J / 8) * 8 if dtype == "float32" else 0)
    if J == 512:
        assert geo["cells"] == (128 if dtype == "bfloat16" else 64), geo
    assert rnnt_joint.launch_geometry(B, T2, U1, 2800, V, tdt) is None


# ---------------------------------------------------------------- K4

def _split_einsum(eq, a, b, terms):
    """einsum(eq, a, b) as the f32 launchers form it: a and b as `terms`
    bf16 terms each, the leading cross products (i + j < terms) summed."""
    A, B = _split(a, terms), _split(b, terms)
    return sum(torch.einsum(eq, x, y) for i, x in enumerate(A) for j, y in enumerate(B) if i + j < terms)


def _emulate_k4(q, k, v, d_out, lens, scale, rate=0.0, keep=None, bias=None, terms=attention.TERMS):
    """(out, dq, dk, dv, d bias) as K4's f32 launchers compute them, for q,
    k, v, d_out (B, T, H, D) float32: the scores and dPd of split products,
    (+ bias) * scale, -inf at masked keys; P = exp(s - max) dropped and
    scaled, split, times V's terms, over the row sum (which counts dropped
    keys); lse = max + log sum; the backward recomputes P from lse, delta =
    dO . O, dS = P (dP - delta) scale in float32, and dQ, dK, dV of split
    products (dS and Pd split too)."""
    T = q.shape[1]
    mask = torch.arange(T)[None, None, None, :] < lens[:, None, None, None]
    kf = torch.ones(()) if rate == 0.0 else torch.where(keep, torch.tensor(1.0 / (1.0 - rate)), torch.tensor(0.0))

    def scores():
        s = _split_einsum("bqhd,bkhd->bhqk", q, k, terms)
        s = (s + bias if bias is not None else s) * scale
        return torch.where(mask, s, torch.tensor(-math.inf))

    s = scores()
    mx = s.amax(-1, keepdim=True)
    live = torch.isfinite(mx)  # lens > 0
    e = torch.exp(s - torch.where(live, mx, torch.zeros(())))
    row_sum = e.sum(-1, keepdim=True)
    out = _split_einsum("bhqk,bkhd->bhqd", e * kf, v, terms) / torch.where(live, row_sum, torch.ones(()))
    out = out.transpose(1, 2)
    lse = torch.where(live, mx + torch.log(row_sum), torch.zeros(()))
    p = torch.exp(scores() - lse)
    dp = _split_einsum("bqhd,bkhd->bhqk", d_out, v, terms) * kf
    delta = (d_out * out).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - delta) * scale
    dq = _split_einsum("bhqk,bkhd->bqhd", ds, k, terms)
    dk = _split_einsum("bhqk,bqhd->bkhd", ds, q, terms)
    dv = _split_einsum("bhqk,bqhd->bkhd", p * kf, d_out, terms)
    return out, dq, dk, dv, ds


def _k4_case(seed, B, T, H, D, with_bias, rate):
    """numpy-seeded q, k, v, d_out, lens (full, ragged, one key), the bias
    scaled as `chip_smoke.check_attention_bias` scales it (sqrt(D), so that
    it weighs as much as q k^T), and a keep mask of `rate`."""
    rng = np.random.default_rng(seed)
    q, k, v, d_out = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(4))
    bias = (rng.normal(size=(B, H, T, T)) * D ** 0.5).astype(np.float32) if with_bias else None
    lens = np.array([T, 1] + list(rng.integers(1, T, size=B - 2)), np.int32)[:B]
    keep = rng.random((B, H, T, T)) >= rate if rate > 0 else None
    return q, k, v, d_out, lens, bias, keep


def _hold_k4(got, want, name, margin=1.0):
    """out within ATTN_TOL (f32, 1e-5), dq, dk, dv and d bias within
    ATTN_BWD_TOL (1e-4), each over `margin`: the largest errors."""
    tols = [chip_smoke.ATTN_TOL[torch.float32]] + [chip_smoke.ATTN_BWD_TOL] * 4
    return [chip_smoke._require_close(f"{name} {what}", a, b, tol / margin, 0.0)
            for what, a, b, tol in zip(("out", "dq", "dk", "dv", "d bias"), got, want, tols) if b is not None]


K4_SHAPES = [(2, 399, 4, 64), (2, 200, 2, 128)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("B,T,H,D", K4_SHAPES)
def test_k4_split_products_match_plain(B, T, H, D, with_bias, rate):
    """The emulated f32 launchers against `attention_plain` /
    `attention_bwd_plain` with the same keep mask, within half the card's
    tolerances (three terms leave ~1e-6)."""
    q, k, v, d_out, lens, bias, keep = (None if x is None else torch.from_numpy(x)
                                        for x in _k4_case(B * T + D + with_bias, B, T, H, D, with_bias, rate))
    scale = 1.0 / math.sqrt(D)
    got = _emulate_k4(q, k, v, d_out, lens, scale, rate, keep, bias)
    want_out = attention.attention_plain(q, k, v, lens, scale, rate, bias=bias, dropout_mask=keep)
    dq, dk, dv, d_bias = attention.attention_bwd_plain(q, k, v, d_out, lens, scale, rate, bias, keep)
    _hold_k4(got, (want_out, dq, dk, dv, d_bias), f"K4 f32 {(B, T, H, D)} bias {with_bias} rate {rate}", margin=2.0)
    past = torch.arange(T)[None, :] >= lens[:, None].long()
    assert not got[2][past].any() and not got[3][past].any()  # dk, dv at masked keys


def _jax_k4(monkeypatch, q, k, v, d_out, lens, bias, scale, rate):
    """(out, dq, dk, dv, d bias) through the JAX `_fused` (Pallas, interpret
    mode, float32) with the keep mask of `_hash_keep`."""
    threshold = np.uint32(int(rate * 2 ** 32))

    def drop_mask(seed_ref, rate_, shape):
        from jax.experimental import pallas as pl

        u32 = lambda x: jnp.asarray(x).astype(jnp.uint32)
        i = jax.lax.broadcasted_iota(jnp.uint32, shape, 0)
        j = jax.lax.broadcasted_iota(jnp.uint32, shape, 1)
        return _hash_keep(u32(pl.program_id(0)), u32(pl.program_id(1)), i, j, u32(pl.num_programs(1)), threshold)

    monkeypatch.setattr(jap, "_drop_mask", drop_mask)
    bhtd = lambda x: jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))
    jb = None if bias is None else jnp.asarray(bias)

    def f(q_, k_, v_, b_):
        return jap._fused((scale, rate, True, b_ is not None), q_, k_, v_, b_, jnp.asarray(lens),
                          jnp.zeros((), jnp.int32))

    out, vjp = jax.vjp(f, bhtd(q), bhtd(k), bhtd(v), jb)
    grads = vjp(bhtd(d_out))
    back = lambda x: torch.from_numpy(np.transpose(np.array(x), (0, 2, 1, 3)))
    return (back(out), back(grads[0]), back(grads[1]), back(grads[2]),
            None if bias is None else torch.from_numpy(np.array(grads[3])))


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [False, True])
def test_k4_split_products_match_jax(monkeypatch, with_bias, rate):
    """The emulated f32 launchers against the JAX package's
    `fused_self_attention` kernels (`_fwd_kernel`, `_bwd_kernel`, interpret
    mode) on the same numpy-seeded inputs and keep mask, within the card's
    tolerances."""
    B, T, H, D = 2, 150, 2, 64
    q, k, v, d_out, lens, bias, _ = _k4_case(11 + with_bias, B, T, H, D, with_bias, 0.0)
    scale = 1.0 / math.sqrt(D)
    want = _jax_k4(monkeypatch, q, k, v, d_out, lens, bias, scale, rate)
    ii, jj = np.meshgrid(np.arange(T, dtype=np.uint32), np.arange(T, dtype=np.uint32), indexing="ij")
    keep = np.stack([np.stack([_hash_keep(np.uint32(b), np.uint32(h), ii, jj, np.uint32(H),
                                          np.uint32(int(rate * 2 ** 32))) for h in range(H)]) for b in range(B)])
    t = lambda x: None if x is None else torch.from_numpy(x)
    got = _emulate_k4(t(q), t(k), t(v), t(d_out), t(lens), scale, rate, t(keep) if rate > 0 else None, t(bias))
    _hold_k4(got, want, f"K4 f32 bias {with_bias} rate {rate}, emulated vs JAX")


def test_k4_split_is_needed():
    """One term fewer (two terms, the three products of K7) misses the f32
    forward's tolerance: the third term carries the float32 operands."""
    q, k, v, d_out, lens, bias, keep = (None if x is None else torch.from_numpy(x)
                                        for x in _k4_case(5, 4, 399, 4, 64, True, 0.1))
    scale = 1.0 / 8.0
    want = attention.attention_plain(q, k, v, lens, scale, 0.1, bias=bias, dropout_mask=keep)
    got = _emulate_k4(q, k, v, d_out, lens, scale, 0.1, keep, bias, terms=attention.TERMS - 1)[0]
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke._require_close("K4 f32 forward, two terms", got, want, chip_smoke.ATTN_TOL[torch.float32], 0.0)


def _encoder_depths():
    """(name, d_k) of every shipped ASR configuration's encoder attention."""
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "*", "*.yaml"))):
        if os.sep + "lm" + os.sep in path:
            continue
        cfg = load_config(path)
        if getattr(cfg, "enc_hidden_size", 0) and getattr(cfg, "enc_num_attention_heads", 0):
            out.append((os.path.relpath(path, REPO), cfg.enc_hidden_size // cfg.enc_num_attention_heads))
    return out


ENCODER_DEPTHS = _encoder_depths()


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("instance", [64, 128])
def test_k4_launch_geometry_fits(instance, with_bias):
    """Every f32 kernel's shared memory within the 232,448 bytes of one
    block on sm_90 for every D the instance takes (D <= 64: the operands as
    bf16 planes; 64 < D <= 128: as f32 rows) and every shipped encoder's
    d_k, with the bias and without; two blocks an SM's 228 KB at the
    shipped d_k; the grid within CUDA's limits and the backward's scratch
    at a full L1 batch."""
    depths = range(1, 65) if instance == 64 else range(65, 129)
    depths = sorted(set(depths) | {d for _, d in ENCODER_DEPTHS if (d <= 64) == (instance == 64)})
    assert depths
    for D in depths:
        geo = attention.launch_geometry(18, 399, 4, D, with_bias)
        for kind in attention.KINDS:
            g = geo[kind]
            assert g["smem"] == attention.smem_bytes(kind, D, with_bias) <= attention.MAX_SMEM, (D, kind)
            assert g["threads"] == 128 and g["grid"] == (7, 4, 18)
        assert geo["planes_bwd"] == (12 * 18 * 4 * 399 * math.ceil(D / 16) * 16 if instance == 64 else 0)
        if D == 64:
            for kind in attention.KINDS:
                assert 2 * (geo[kind]["smem"] + 1024) <= 228 * 1024, (kind, geo[kind])
    assert {d for _, d in ENCODER_DEPTHS} == {64}, ENCODER_DEPTHS
