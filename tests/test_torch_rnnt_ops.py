"""The port's RNN-T ops (`emoasr_tpu_torch/ops/rnnt.py`, `ops/rnnt_joint.py`)
against the JAX package's, on the CPU.

- The row-scan lattice (closed form in float64) and the `full` loss
  against JAX `rnnt_loss_rowscan` and `rnnt_loss` (anti-diagonal scan),
  values and gradients to the joint logits, with T' = 1 and U = 0
  utterances in the batch.  Tolerance: rtol 1e-5 on the losses (the JAX
  lattice sums in float32); gradients 1e-4 of the largest entry + 1e-7.
- The fused joint's plain version (K7's) against JAX
  `fused_joint_gather_fwd` (interpret mode) and `rnnt_gathered_from_joint`,
  padded labels (eos) included: 1e-5 absolute (log-probabilities of
  magnitude ~5, float32 products of J terms).
- Gradients of the port's `autograd.Function`s (K7's, and the chunked
  mode's) to h_enc, h_dec, w and b against the VJP of JAX
  `fused_joint_gather`: 1e-5 of the largest entry + 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emoasr_tpu.ops.rnnt as jr
import emoasr_tpu.ops.rnnt_pallas as jrp
from emoasr_tpu_torch.ops import rnnt, rnnt_joint

T_ = torch.from_numpy


def _lattice_case(seed, B=4, T=9, U1=5, V=7):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, U1, V)).astype(np.float32)
    labels = rng.integers(1, V, size=(B, U1 - 1)).astype(np.int32)
    xlens = np.array([T, T - 3, 1, 4], np.int32)[:B]  # a single-frame utterance
    ylens = np.array([U1 - 1, 2, 1, 0], np.int32)[:B]  # and one with no label
    return logits, labels, xlens, ylens


def _jax_loss_grad(fn, logits, labels, xlens, ylens):
    args = (jnp.asarray(labels), jnp.asarray(xlens), jnp.asarray(ylens))
    nll = fn(jax.nn.log_softmax(jnp.asarray(logits), -1), *args, reduction="none")
    g = jax.grad(lambda x: fn(jax.nn.log_softmax(x, -1), *args, reduction="sum"))(jnp.asarray(logits))
    return np.asarray(nll), np.asarray(g)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["rnnt_loss", "rnnt_loss_rowscan"])
def test_lattice_losses_match_jax(seed, name):
    logits, labels, xlens, ylens = _lattice_case(seed)
    want, want_g = _jax_loss_grad(getattr(jr, name), logits, labels, xlens, ylens)
    x = T_(logits).requires_grad_(True)
    fn = getattr(rnnt, name)
    nll = fn(torch.log_softmax(x, -1), T_(labels), T_(xlens), T_(ylens), reduction="none")
    np.testing.assert_allclose(nll.detach().numpy(), want, rtol=1e-5)
    (g,) = torch.autograd.grad(nll.sum(), x)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=0, atol=1e-4 * np.abs(want_g).max() + 1e-7)
    mean = fn(torch.log_softmax(x, -1), T_(labels), T_(xlens), T_(ylens))
    np.testing.assert_allclose(mean.item(), want.mean(), rtol=1e-5)


def test_rowscan_long_lattice_keeps_precision():
    """A 200 x 41 lattice: |ll| in the hundreds, the closed-form rows in
    float64 within 1e-5 relative of the JAX row scan."""
    logits, labels, xlens, ylens = _lattice_case(3, B=2, T=200, U1=41, V=9)
    xlens, ylens = np.array([200, 150], np.int32), np.array([40, 23], np.int32)
    want, _ = _jax_loss_grad(jr.rnnt_loss_rowscan, logits, labels, xlens, ylens)
    got = rnnt.rnnt_loss_rowscan(torch.log_softmax(T_(logits), -1), T_(labels), T_(xlens), T_(ylens),
                                 reduction="none")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert np.abs(want).min() > 100


def _joint_case(seed, B=2, T=11, U1=6, J=16, V=40):
    rng = np.random.default_rng(seed)
    h_enc = rng.normal(size=(B, T, J)).astype(np.float32)
    h_dec = rng.normal(size=(B, U1, J)).astype(np.float32)
    w = (0.3 * rng.normal(size=(J, V))).astype(np.float32)
    b = rng.normal(size=(V,)).astype(np.float32)
    labels = rng.integers(1, V, size=(B, U1 - 1)).astype(np.int32)
    labels[1, 3:] = 2  # eos padding, a valid id
    return h_enc, h_dec, w, b, labels


@pytest.mark.parametrize("T,V", [(11, 40), (40, 24)])  # T below and above the chunk of 32
def test_joint_plain_matches_jax_kernel_and_chunked(T, V):
    h_enc, h_dec, w, b, labels = _joint_case(T, T=T, V=V)
    jin = [jnp.asarray(a) for a in (h_enc, h_dec, w, b, labels)]
    kb, kl = jrp.fused_joint_gather_fwd(*jin, blank_id=0, t_chunk=4, v_chunk=16)
    cb, cl = jr.rnnt_gathered_from_joint(*jin, blank_id=0)
    tin = [T_(a) for a in (h_enc, h_dec, w, b, labels)]
    for pb, pl_ in (rnnt.joint_gather_plain(*tin), rnnt_joint.fused_joint_gather(*tin),
                    rnnt.rnnt_gathered_from_joint(*tin)):
        for got, want in ((pb, kb), (pl_, kl), (pb, cb), (pl_, cl)):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert rnnt_joint.KERNEL.launches == 0 and rnnt_joint.KERNEL._lib is None


def test_joint_takes_the_linear_layer_weight_in_place():
    """`w_out` as the `.t()` view of an (V, J) weight gives the same."""
    h_enc, h_dec, w, b, labels = _joint_case(5)
    tin = [T_(a) for a in (h_enc, h_dec, w, b, labels)]
    a = rnnt_joint.fused_joint_gather(*tin)
    wt = T_(np.ascontiguousarray(w.T)).t()
    c = rnnt_joint.fused_joint_gather(tin[0], tin[1], wt, tin[3], tin[4])
    assert all(torch.equal(x, y) for x, y in zip(a, c))
    with pytest.raises(ValueError, match="labels length"):
        rnnt_joint.fused_joint_gather(tin[0], tin[1], tin[2], tin[3], tin[4][:, :-1])


def test_joint_gradients_match_jax_vjp():
    h_enc, h_dec, w, b, labels = _joint_case(9, T=37)
    rng = np.random.default_rng(1)
    gb = rng.normal(size=(2, 37, 6)).astype(np.float32)
    gl = rng.normal(size=(2, 37, 5)).astype(np.float32)
    jin = [jnp.asarray(a) for a in (h_enc, h_dec, w, b)]
    _, vjp = jax.vjp(lambda *a: jrp.fused_joint_gather(*a, jnp.asarray(labels), 0), *jin)
    want = vjp((jnp.asarray(gb), jnp.asarray(gl)))
    for fn in (rnnt_joint.fused_joint_gather, rnnt.rnnt_gathered_from_joint):
        tin = [T_(a.copy()).requires_grad_(True) for a in (h_enc, h_dec, w, b)]
        lpb, lpl = fn(*tin, T_(labels), 0)
        got = torch.autograd.grad((lpb * T_(gb)).sum() + (lpl * T_(gl)).sum(), tin)
        for g, wg in zip(got, want):
            wg = np.asarray(wg)
            np.testing.assert_allclose(g.numpy(), wg, rtol=0, atol=1e-5 * np.abs(wg).max() + 1e-6)
    # only one output used: the other's cotangent is zero
    tin = [T_(a.copy()).requires_grad_(True) for a in (h_enc, h_dec, w, b)]
    lpb, _ = rnnt_joint.fused_joint_gather(*tin, T_(labels), 0)
    _, vjp0 = jax.vjp(lambda *a: jrp.fused_joint_gather(*a, jnp.asarray(labels), 0), *jin)
    want0 = vjp0((jnp.asarray(gb), jnp.zeros((2, 37, 5), jnp.float32)))
    got0 = torch.autograd.grad((lpb * T_(gb)).sum(), tin)
    for g, wg in zip(got0, want0):
        wg = np.asarray(wg)
        np.testing.assert_allclose(g.numpy(), wg, rtol=0, atol=1e-5 * np.abs(wg).max() + 1e-6)
