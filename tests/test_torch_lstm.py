"""The port's LSTM (`emoasr_tpu_torch/ops/lstm.py`, `ops/lstm_scan.py`)
against the JAX package's, on the CPU.

- `lstm_scan` (the plain scan here) and `lstm_scan_fused` (the K8 wrapper:
  its plain forward and its plain reverse recurrence as the backward)
  against JAX `lstm_scan` and `lstm_scan_pallas` (interpret mode): values
  and the gradients to x_proj, w_hh, h0 and c0 of one loss of all three
  outputs.  T below and above the fused-kernel threshold (8) and across
  the JAX kernel's time chunk, H not a multiple of 128, h0 and c0 nonzero.
- `UniLSTM`, `StackedLSTM` and `BiLSTM` with the JAX weights carried over,
  and `reverse_by_length`.

Tolerances: values 1e-5 absolute (float32 sums of H terms through T
steps, two frameworks' orders); gradients 1e-5 of the largest entry of
each tensor + 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emoasr_tpu.ops.lstm as jlstm
import emoasr_tpu.ops.lstm_pallas as jlp
from emoasr_tpu_torch.ops import lstm, lstm_scan

T_ = torch.from_numpy


def _inputs(seed, B, T, H):
    rng = np.random.default_rng(seed)
    xp = (0.5 * rng.normal(size=(B, T, 4 * H))).astype(np.float32)
    whh = (0.1 * rng.normal(size=(4 * H, H))).astype(np.float32)
    h0 = (0.5 * rng.normal(size=(B, H))).astype(np.float32)
    c0 = (0.5 * rng.normal(size=(B, H))).astype(np.float32)
    wy = rng.normal(size=(B, T, H)).astype(np.float32)  # cotangent weights of ys
    return xp, whh, h0, c0, wy


def _jax_loss(fn, wy):
    def f(xp, whh, h0, c0):
        ys, (h, c) = fn(xp, whh, h0, c0)
        return (ys * wy).sum() + (h * h).sum() + 0.3 * c.sum()

    return f


def _torch_grads(fn, xp, whh, h0, c0, wy):
    ins = [T_(a.copy()).requires_grad_(True) for a in (xp, whh, h0, c0)]
    ys, (h, c) = fn(*ins)
    loss = (ys * T_(wy)).sum() + (h * h).sum() + 0.3 * c.sum()
    return (ys, h, c), torch.autograd.grad(loss, ins)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=tol * np.abs(want).max() + 1e-6)


@pytest.mark.parametrize("B,T,H", [
    (3, 5, 24),     # T < 8: the scan on every device
    (4, 12, 40),    # T >= 8, H not a multiple of 128
    (2, 37, 136),   # T across the JAX kernel's time chunks, H past 128
])
def test_lstm_scan_values_and_gradients_match_jax(B, T, H):
    xp, whh, h0, c0, wy = _inputs(B * 100 + T, B, T, H)
    jin = [jnp.asarray(a) for a in (xp, whh, h0, c0)]
    ys0, (h0_, c0_) = jlstm.lstm_scan(*jin)
    ys1, (h1_, c1_) = jlp.lstm_scan_pallas(*jin)
    np.testing.assert_allclose(np.asarray(ys0), np.asarray(ys1), atol=1e-5)  # the two JAX routes agree
    jg = jax.grad(_jax_loss(jlstm.lstm_scan, jnp.asarray(wy)), argnums=(0, 1, 2, 3))(*jin)
    jgp = jax.grad(_jax_loss(jlp.lstm_scan_pallas, jnp.asarray(wy)), argnums=(0, 1, 2, 3))(*jin)
    for fn in (lstm.lstm_scan, lstm_scan.lstm_scan_fused):
        (ys, h, c), grads = _torch_grads(fn, xp, whh, h0, c0, wy)
        np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys0), rtol=0, atol=1e-5)
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(h0_), rtol=0, atol=1e-5)
        np.testing.assert_allclose(c.detach().numpy(), np.asarray(c0_), rtol=0, atol=1e-5)
        for g, want, want_p in zip(grads, jg, jgp):
            _close(g, want)
            _close(g, want_p)
    assert lstm_scan.KERNEL.launches == 0 and lstm_scan.KERNEL._lib is None


def test_plain_backward_is_the_reverse_recurrence():
    """`lstm_bwd_plain` (the kernel's arithmetic) against autograd through
    `lstm_fwd_plain`, with unused outputs' cotangents zero (tolerance 1e-5
    of the largest entry: one framework, two orders of the same sums)."""
    xp, whh, h0, c0, wy = _inputs(7, 3, 9, 16)
    ins = [T_(a.copy()).requires_grad_(True) for a in (xp, whh, h0, c0)]
    ys, hT, cT, gates, hcprev = lstm_scan.lstm_fwd_plain(*ins)
    want = torch.autograd.grad((ys * T_(wy)).sum() + hT.sum(), ins)
    dxp, dw, dh0, dc0 = lstm_scan.lstm_bwd_plain(gates.detach(), hcprev.detach(), T_(wy), torch.ones(3, 16),
                                                 torch.zeros(3, 16), ins[1].detach())
    for g, w in zip((dxp, dw, dh0, dc0), want):
        _close(g, w.numpy())
    assert dw.dtype == torch.float32 and gates.shape == (9, 3, 64) and hcprev.shape == (9, 3, 32)


def test_uni_and_stacked_lstm_match_jax():
    B, T, I, H = 3, 10, 12, 20
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(B, T, I)).astype(np.float32)
    st = (0.3 * rng.normal(size=(2, 2, B, H))).astype(np.float32)
    jm = jlstm.StackedLSTM(H, 2)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(xs))["params"]
    params = jax.tree_util.tree_map(lambda a: (0.3 * rng.normal(size=a.shape)).astype(np.float32), params)
    want, want_st = jm.apply({"params": params}, jnp.asarray(xs), jnp.asarray(st))

    tm = lstm.StackedLSTM(I, H, 2).eval()
    sd = {f"{i}.{n}_l0": T_(np.asarray(params[f"layer{i}"][n]))
          for i in range(2) for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
    assert set(sd) == set(tm.state_dict())  # nn.LSTM's names under the layer index
    tm.load_state_dict(sd)
    got, got_st = tm(T_(xs), T_(st))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_st.detach().numpy(), np.asarray(want_st), rtol=0, atol=1e-5)
    # one layer, zero initial state
    uni = jlstm.UniLSTM(H)
    want1, _ = uni.apply({"params": params["layer0"]}, jnp.asarray(xs))
    got1, _ = tm[0](T_(xs))
    np.testing.assert_allclose(got1.detach().numpy(), np.asarray(want1), rtol=0, atol=1e-5)


def test_bilstm_and_reverse_by_length_match_jax():
    B, T, I, H = 3, 9, 6, 10
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(B, T, I)).astype(np.float32)
    lens = np.array([9, 4, 1], np.int32)
    np.testing.assert_array_equal(
        lstm.reverse_by_length(T_(xs), T_(lens)).numpy(),
        np.asarray(jlstm.reverse_by_length(jnp.asarray(xs), jnp.asarray(lens))))
    jm = jlstm.BiLSTM(H)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(xs), jnp.asarray(lens))["params"]
    params = jax.tree_util.tree_map(lambda a: (0.3 * rng.normal(size=a.shape)).astype(np.float32), params)
    want = jm.apply({"params": params}, jnp.asarray(xs), jnp.asarray(lens))
    tm = lstm.BiLSTM(I, H)
    sd = {f"{n}_l0{sfx}": T_(np.asarray(params[d][n]))
          for d, sfx in (("fwd", ""), ("bwd", "_reverse")) for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
    assert set(sd) == set(tm.state_dict())  # nn.LSTM(bidirectional=True)'s names
    tm.load_state_dict(sd)
    got = tm(T_(xs), T_(lens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert (got[2, 1:] == 0).all()


def test_kernel_route_rules():
    """A CPU tensor never builds or launches the kernel; an unsupported
    device raises instead of falling back."""
    xp, whh, h0, c0, _ = _inputs(0, 2, 9, 8)
    lstm.lstm_scan(*(T_(a) for a in (xp, whh, h0, c0)))
    assert lstm_scan.KERNEL.launches == 0 and lstm_scan.KERNEL._lib is None
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_scan.lstm_scan_fused(*(T_(a).to("meta") for a in (xp, whh, h0, c0)))
