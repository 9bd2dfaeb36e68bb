"""The bf16 parts of the port's kernels (their plain versions, which CPU
tensors take) against the JAX package's Pallas kernels run in interpret
mode, on the CPU, with the same numpy-seeded inputs; and K1 at a hidden
size above 256.

- K1 `fused_ctc_head`: lse, xs and the three gradients, bf16 at H = 16 and
  H = 320, f32 at H = 320.
- K4's backward in bf16, with and without the score bias, without dropout
  and with a shared keep mask: the JAX side runs its own `_bwd_kernel`
  (interpret mode) with `_drop_mask` swapped for a hash of (b, h, query,
  key) that the test also hands the port as its mask (the TPU's random
  bits have no CPU lowering).
- K7 `fused_joint_gather` in bf16: the forward (K7's arithmetic, f32
  log-probabilities) and the gradients (the chunked route's VJP in bf16;
  see the test for their tolerance).
- K8 `lstm_scan_pallas` in bf16: ys, h_T, c_T and the gradients to x_proj,
  w_hh, h0 and c0, from the rounded residuals.

Tolerances.  float32 outputs whose products are exact (bf16 values) and
whose sums differ only in order: 1e-5 absolute at magnitudes of a few
units (log-sum-exps over V).  bf16 outputs are the same float32 sums
rounded once, so where the two sums straddle a rounding boundary they
differ by one bf16 step: each entry within 2^-7 of its magnitude (one
bf16 ulp at most) plus a floor of 2^-7 of the tensor's largest entry for
entries whose inputs went through such a step upstream (a rounded dS, Pd
or z enters several sums).  The bf16 LSTM runs 12 steps on a float32
carry that both sides compute in another order: its outputs and gradients
are held to 2 bf16 steps of each tensor's largest entry.
"""

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import emoasr_tpu.ops.attention_pallas as jap
import emoasr_tpu.ops.lstm_pallas as jlp
import emoasr_tpu.ops.rnnt as jr
import emoasr_tpu.ops.rnnt_pallas as jrp
from emoasr_tpu.ops import ctc as jctc
from emoasr_tpu.ops.ctc_head_pallas import fused_ctc_head as jax_head
from emoasr_tpu_torch.ops import attention, ctc_head, lstm_scan, rnnt, rnnt_joint

T_ = torch.from_numpy
ULP = 2.0 ** -7  # a bf16 step, relative to the value (8 significant bits)


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16, kept as float32."""
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


def _np(x) -> np.ndarray:
    return np.asarray(x.float().detach().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32))


def _close_bf16(got, want, name="", floor=ULP):
    """Within one bf16 step of each entry, plus `floor` times the largest."""
    g, w = _np(got), _np(want)
    np.testing.assert_allclose(g, w, rtol=ULP, atol=floor * np.abs(w).max() + 1e-30, err_msg=name)


# ---------------------------------------------------------------- K1


def _head_case(seed, B=3, Tn=25, H=16, V=37, U=6):
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


@pytest.mark.parametrize("dtype,H", [("bfloat16", 16), ("float32", 320), ("bfloat16", 320)])
def test_ctc_head_matches_jax(dtype, H):
    """K1 in bf16 and at H > 256 (the kernel streams H in chunks of 256):
    lse and xs float32, the gradients in the inputs' dtype."""
    e, w, b, z, g_lse, g_xs = _head_case(H, H=H)
    if dtype == "bfloat16":
        e, w, b = _bf16(e), _bf16(w), _bf16(b)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    S = z.shape[1]

    def jf(e_, w_, b_):
        lse, xs = jax_head(e_, w_, b_, jnp.asarray(z))
        return lse, xs[:, :, :S]

    (jlse, jxs), vjp = jax.vjp(jf, *(jnp.asarray(x).astype(jdt) for x in (e, w, b)))
    jg = vjp((jnp.asarray(g_lse), jnp.asarray(g_xs)))
    te, tw, tb = (T_(x).to(tdt).requires_grad_(True) for x in (e, w, b))
    lse, xs = ctc_head.fused_ctc_head(te, tw, tb, T_(z))
    tg = torch.autograd.grad((lse, xs), (te, tw, tb), (T_(g_lse), T_(g_xs)))
    assert lse.dtype == xs.dtype == torch.float32 and all(g.dtype == tdt for g in tg)
    np.testing.assert_allclose(_np(lse), _np(jlse), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(xs), _np(jxs), rtol=0, atol=1e-5)
    for name, a, c in zip(("d e", "d w", "d b"), tg, jg):
        assert c.dtype == jdt
        if dtype == "bfloat16":
            _close_bf16(a, c, name, floor=0.0)
        else:
            np.testing.assert_allclose(_np(a), _np(c), rtol=1e-4, atol=1e-5, err_msg=name)
    assert ctc_head.KERNEL.launches == 0


# ---------------------------------------------------------------- K4


def _hash_keep(b, h, i, j, n_heads, threshold):
    """A keep mask from a hash of (b, h, query, key), in uint32 arithmetic
    (wrapping) that numpy and jax.numpy both compute."""
    with np.errstate(over="ignore"):
        x = (i * np.uint32(0x9E3779B1)) ^ (j * np.uint32(0x85EBCA77)) ^ ((b * n_heads + h) * np.uint32(0xC2B2AE3D))
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x2C1B3C6D)
        x = x ^ (x >> np.uint32(12))
    return x >= threshold


def _attn_case(seed, B, T, H, D, with_bias):
    rng = np.random.default_rng(seed)
    mk = lambda *s: _bf16(rng.normal(size=s).astype(np.float32))
    q, k, v, d_out = mk(B, T, H, D), mk(B, T, H, D), mk(B, T, H, D), mk(B, T, H, D)
    bias = mk(B, H, T, T) if with_bias else None
    return q, k, v, d_out, bias


def _jax_attention_vjp(monkeypatch, q, k, v, d_out, bias, lens, scale, rate):
    """(out, dq, dk, dv, d bias) through the JAX kernels in interpret mode,
    with the keep mask of `_hash_keep`."""
    threshold = np.uint32(int(rate * 2 ** 32))

    def drop_mask(seed_ref, rate_, shape):
        from jax.experimental import pallas as pl

        u32 = lambda x: jnp.asarray(x).astype(jnp.uint32)
        i = jax.lax.broadcasted_iota(jnp.uint32, shape, 0)
        j = jax.lax.broadcasted_iota(jnp.uint32, shape, 1)
        return _hash_keep(u32(pl.program_id(0)), u32(pl.program_id(1)), i, j, u32(pl.num_programs(1)), threshold)

    monkeypatch.setattr(jap, "_drop_mask", drop_mask)
    bhtd = lambda x: jnp.transpose(jnp.asarray(x).astype(jnp.bfloat16), (0, 2, 1, 3))
    args = [bhtd(q), bhtd(k), bhtd(v)]
    jb = None if bias is None else jnp.asarray(bias).astype(jnp.bfloat16)

    def f(q_, k_, v_, b_):
        return jap._fused((scale, rate, True, b_ is not None), q_, k_, v_, b_, jnp.asarray(lens),
                          jnp.zeros((), jnp.int32))

    out, vjp = jax.vjp(f, *args, jb)
    grads = vjp(bhtd(d_out))
    back = lambda x: np.transpose(_np(x), (0, 2, 1, 3))
    return back(out), back(grads[0]), back(grads[1]), back(grads[2]), None if bias is None else _np(grads[3])


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_backward_bf16_matches_jax_kernel(monkeypatch, with_bias, rate):
    """dq, dk, dv (and d bias) in bf16 against the JAX `_bwd_kernel`: P
    float32, Pd and dS rounded to bf16 before their products."""
    B, T, H, D = 2, 21, 2, 8
    q, k, v, d_out, bias = _attn_case(7 + with_bias, B, T, H, D, with_bias)
    lens = np.array([21, 9], np.int32)
    scale = 1.0 / math.sqrt(D)
    ref = _jax_attention_vjp(monkeypatch, q, k, v, d_out, bias, lens, scale, rate)
    ii, jj = np.meshgrid(np.arange(T, dtype=np.uint32), np.arange(T, dtype=np.uint32), indexing="ij")
    keep = np.stack([np.stack([_hash_keep(np.uint32(b), np.uint32(h), ii, jj, np.uint32(H),
                                          np.uint32(int(rate * 2 ** 32))) for h in range(H)]) for b in range(B)])
    if rate > 0:
        assert 0.6 < keep.mean() < 0.8
    ins = [T_(x).bfloat16().requires_grad_(True) for x in (q, k, v)]
    tb = None if bias is None else T_(bias).bfloat16().requires_grad_(True)
    out = attention.fused_self_attention(*ins, T_(lens), scale=scale, dropout_rate=rate, deterministic=rate == 0,
                                         bias=tb, dropout_mask=T_(keep) if rate > 0 else None)
    grads = torch.autograd.grad(out, ins + ([tb] if tb is not None else []), T_(d_out).bfloat16())
    assert out.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in grads)
    for name, a, c in zip(("out", "dq", "dk", "dv", "d bias"), (out, *grads), ref):
        _close_bf16(a, c, name)
    assert not _np(grads[1])[1, 9:].any() and not _np(grads[2])[1, 9:].any()  # dk, dv at masked keys
    assert attention.KERNEL.launches == 0


# ---------------------------------------------------------------- K7


def _joint_case(seed, B=2, T=37, U1=6, J=16, V=40):
    rng = np.random.default_rng(seed)
    h_enc = _bf16(rng.normal(size=(B, T, J)).astype(np.float32))
    h_dec = _bf16(rng.normal(size=(B, U1, J)).astype(np.float32))
    w = _bf16((0.3 * rng.normal(size=(J, V))).astype(np.float32))
    b = _bf16(rng.normal(size=(V,)).astype(np.float32))
    labels = rng.integers(1, V, size=(B, U1 - 1)).astype(np.int32)
    labels[1, 3:] = 2
    gb = rng.normal(size=(B, T, U1)).astype(np.float32)
    gl = rng.normal(size=(B, T, U1 - 1)).astype(np.float32)
    return h_enc, h_dec, w, b, labels, gb, gl


def test_rnnt_joint_bf16_matches_jax():
    """K7's forward in bf16 (z in bf16, f32 logits and lse) against
    `fused_joint_gather_fwd`; its backward (the chunked route's, in bf16)
    against the VJP of `fused_joint_gather`."""
    h_enc, h_dec, w, b, labels, gb, gl = _joint_case(3)
    jin = [jnp.asarray(a).astype(jnp.bfloat16) for a in (h_enc, h_dec, w, b)]
    (kb, kl), vjp = jax.vjp(lambda *a: jrp.fused_joint_gather(*a, jnp.asarray(labels), 0, t_chunk=4, v_chunk=16),
                            *jin)
    want = vjp((jnp.asarray(gb), jnp.asarray(gl)))
    tin = [T_(a).bfloat16().requires_grad_(True) for a in (h_enc, h_dec, w, b)]
    lpb, lpl = rnnt_joint.fused_joint_gather(*tin, T_(labels), 0)
    assert lpb.dtype == lpl.dtype == torch.float32
    # one z that rounds the other way moves a logit by ~1e-3: no more
    np.testing.assert_allclose(_np(lpb), _np(kb), rtol=0, atol=2e-3)
    np.testing.assert_allclose(_np(lpl), _np(kl), rtol=0, atol=2e-3)
    assert np.mean(np.abs(_np(lpb) - _np(kb)) <= 1e-5) > 0.95  # most cells agree to float32 noise
    got = torch.autograd.grad((lpb * T_(gb)).sum() + (lpl * T_(gl)).sum(), tin)
    # XLA's CPU backend sums the bf16 VJP's reductions over cells (d b, the
    # sums over u and t) in bf16, in an order of its own; the port sums in
    # float32 and rounds once.  So each gradient is held to the float32 VJP
    # within the JAX bf16 VJP's own distance from it, plus one bf16 step of
    # the largest entry: the port is no further from the exact gradient
    # than the JAX function it ports.
    _, vjp32 = jax.vjp(lambda *a: jrp.fused_joint_gather(*a, jnp.asarray(labels), 0, t_chunk=4, v_chunk=16),
                       *(jnp.asarray(a) for a in (h_enc, h_dec, w, b)))
    exact = vjp32((jnp.asarray(gb), jnp.asarray(gl)))
    for name, g, wg, w32 in zip(("d h_enc", "d h_dec", "d w", "d b"), got, want, exact):
        assert g.dtype == torch.bfloat16 and wg.dtype == jnp.bfloat16
        w32 = _np(w32)
        noise = np.abs(_np(wg) - w32).max()
        assert noise < 0.05 * np.abs(w32).max(), name  # the JAX bf16 route itself
        np.testing.assert_allclose(_np(g), w32, rtol=0, atol=noise + ULP * np.abs(w32).max(), err_msg=name)
    # the chunked route in bf16: its logits are bf16, so a logit that rounds
    # the other way moves by one bf16 step of its magnitude (<= 8 here)
    cb, cl = rnnt.rnnt_gathered_from_joint(*(t.detach() for t in tin), T_(labels), 0)
    jcb, jcl = jr.rnnt_gathered_from_joint(*jin, jnp.asarray(labels), 0)
    np.testing.assert_allclose(_np(cb), _np(jcb), rtol=0, atol=8 * ULP)
    np.testing.assert_allclose(_np(cl), _np(jcl), rtol=0, atol=8 * ULP)
    assert rnnt_joint.KERNEL.launches == 0


# ---------------------------------------------------------------- K8


def test_lstm_scan_bf16_matches_jax():
    """K8 in bf16: x_proj, h0, c0 and the stored ys / residuals bf16, w_hh
    and the carry f32; the backward from the rounded residuals."""
    B, T, H = 3, 12, 40
    rng = np.random.default_rng(11)
    xp = _bf16((0.5 * rng.normal(size=(B, T, 4 * H))).astype(np.float32))
    whh = _bf16((0.1 * rng.normal(size=(4 * H, H))).astype(np.float32))
    h0 = _bf16((0.5 * rng.normal(size=(B, H))).astype(np.float32))
    c0 = _bf16((0.5 * rng.normal(size=(B, H))).astype(np.float32))
    wy = _bf16(rng.normal(size=(B, T, H)).astype(np.float32))
    wh = _bf16(rng.normal(size=(B, H)).astype(np.float32))
    wc = _bf16(rng.normal(size=(B, H)).astype(np.float32))
    jin = [jnp.asarray(a).astype(jnp.bfloat16) for a in (xp, whh, h0, c0)]
    (jys, (jh, jc)), vjp = jax.vjp(jlp.lstm_scan_pallas, *jin)
    jg = vjp((jnp.asarray(wy).astype(jnp.bfloat16),
              (jnp.asarray(wh).astype(jnp.bfloat16), jnp.asarray(wc).astype(jnp.bfloat16))))
    tin = [T_(a).bfloat16().requires_grad_(True) for a in (xp, whh, h0, c0)]
    ys, (h, c) = lstm_scan.lstm_scan_fused(*tin)
    tg = torch.autograd.grad((ys, h, c), tin, (T_(wy).bfloat16(), T_(wh).bfloat16(), T_(wc).bfloat16()))
    assert ys.dtype == h.dtype == c.dtype == torch.bfloat16
    for name, a, w_ in zip(("ys", "h_T", "c_T"), (ys, h, c), (jys, jh, jc)):
        _close_bf16(a, w_, name, floor=2 * ULP)
    for name, a, w_ in zip(("d x_proj", "d w_hh", "d h0", "d c0"), tg, jg):
        assert a.dtype == torch.bfloat16 and w_.dtype == jnp.bfloat16
        _close_bf16(a, w_, name, floor=2 * ULP)
    # the stored residuals are bf16, and the backward reads them as stored
    _, _, _, gates, hcprev = lstm_scan.lstm_fwd_plain(*(t.detach() for t in tin))
    assert gates.dtype == hcprev.dtype == torch.bfloat16
    assert lstm_scan.KERNEL.launches == 0
