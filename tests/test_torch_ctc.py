"""Port CTC ops (their plain versions, which CPU tensors take) against the
JAX package's, whose Pallas kernels run in interpret mode off-TPU.

Inputs are made with numpy from a seed and fed to both sides.  Tolerances:
the lattice and the head are float32 sums taken in different orders by the
two frameworks, so values are held to rtol 1e-5 and gradients to
rtol 1e-4 + atol 1e-5 (gradients wrt the head weights add B*T rows).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from emoasr_tpu.ops import ctc as jctc
from emoasr_tpu.ops.ctc_head_pallas import fused_ctc_head as jax_head
from emoasr_tpu.ops.ctc_pallas import ctc_ll_from_path as jax_ll
from emoasr_tpu_torch.ops import ctc as tctc
from emoasr_tpu_torch.ops import ctc_head, ctc_lattice
from emoasr_tpu_torch.ops.common import LOG_0, flip_by_length

FIXDIR = os.path.dirname(os.path.abspath(__file__))
T = torch.from_numpy


def _lattice_inputs(seed=0, B=5, Tn=23, U=6, V=9):
    """Ragged xlens, ylens == 0 (row 1), repeated labels (row 0), and one
    row whose xlen is too short for its labels (row 2: infeasible)."""
    rng = np.random.default_rng(seed)
    lp = jax.nn.log_softmax(jnp.asarray(rng.normal(size=(B, Tn, V)).astype(np.float32)), -1)
    lp = np.asarray(lp)
    labels = rng.integers(1, V, size=(B, U)).astype(np.int32)
    labels[0, :4] = [3, 3, 3, 5]
    xlens = np.array([Tn, 17, 3, 20, 13][:B], np.int32)
    ylens = np.array([U, 0, U, 4, 1][:B], np.int32)
    return lp, labels, xlens, ylens


def test_lattice_ll_and_grad_match_jax():
    lp, labels, xlens, ylens = _lattice_inputs()
    z, a2, ini, fin = jctc._path_masks(jnp.asarray(labels), jnp.asarray(ylens), 0)
    lp_path = np.take_along_axis(lp, np.asarray(z)[:, None, :], axis=2).transpose(1, 0, 2).copy()
    g = np.random.default_rng(1).normal(size=(len(xlens),)).astype(np.float32)

    jl, jvjp = jax.vjp(lambda x: jax_ll(x, a2, ini, fin, jnp.asarray(xlens)), jnp.asarray(lp_path))
    (jgrad,) = jvjp(jnp.asarray(g))

    tz, ta2, tini, tfin = tctc._path_masks(T(labels), T(ylens), 0)
    assert np.array_equal(tz.numpy(), np.asarray(z))
    for a, b in ((ta2, a2), (tini, ini), (tfin, fin)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    x = T(lp_path).requires_grad_(True)
    ll = ctc_lattice.ctc_ll_from_path(x, ta2, tini, tfin, T(xlens))
    (grad,) = torch.autograd.grad(ll, x, T(g))

    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-5)
    assert ll[2].item() < LOG_0 / 2  # infeasible: about LOG_0, finite
    assert not grad[:, 2].any()  # and no gradient at all
    past = np.arange(lp_path.shape[0])[:, None] >= xlens[None, :]
    assert not grad.numpy()[past].any()
    assert ctc_lattice.KERNEL.launches == 0  # CPU tensors take the plain version


def test_lattice_takes_a_transposed_view():
    """`ctc_ll_from_path` reads a (T, B, S) view of a (B, T, S) tensor."""
    lp, labels, xlens, ylens = _lattice_inputs(seed=2)
    z, a2, ini, fin = tctc._path_masks(T(labels), T(ylens), 0)
    bts = torch.gather(T(lp), 2, z.long()[:, None, :].expand(-1, lp.shape[1], -1))
    a = ctc_lattice.ctc_ll_from_path(bts.transpose(0, 1), a2, ini, fin, T(xlens))
    b = ctc_lattice.ctc_ll_from_path(bts.transpose(0, 1).contiguous(), a2, ini, fin, T(xlens))
    assert torch.equal(a, b)
    assert ctc_lattice._layout_ok(bts.transpose(0, 1)) and ctc_lattice._layout_ok(b[None, :, None])
    assert not ctc_lattice._layout_ok(bts.transpose(0, 1)[:, :, ::2])


def _head_inputs(seed=11, B=3, Tn=25, H=16, V=37, U=6):
    """V = 37 is a multiple of nothing; labels repeat, and eos pads them."""
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(B, Tn, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(V,)) * 0.1).astype(np.float32)
    ys = rng.integers(1, V, size=(B, U)).astype(np.int32)
    ys[0, :3] = 7
    ys[1, 4:] = 2
    return e, w, b, ys


def test_head_lse_xs_and_grads_match_jax():
    e, w, b, ys = _head_inputs()
    z = np.asarray(jctc._extend_with_blanks(jnp.asarray(ys), 0))
    S = z.shape[1]
    rng = np.random.default_rng(5)
    g_lse = rng.normal(size=e.shape[:2]).astype(np.float32)
    g_xs = rng.normal(size=e.shape[:2] + (S,)).astype(np.float32)
    g_lse[2, 15:] = 0.0  # frames past an utterance's length get no cotangent
    g_xs[2, 15:] = 0.0

    def jf(e_, w_, b_):
        lse, xs = jax_head(e_, w_, b_, jnp.asarray(z))
        return lse, xs[:, :, :S]

    (jlse, jxs), jvjp = jax.vjp(jf, jnp.asarray(e), jnp.asarray(w), jnp.asarray(b))
    jg = jvjp((jnp.asarray(g_lse), jnp.asarray(g_xs)))

    te, tw, tb = (T(x).requires_grad_(True) for x in (e, w, b))
    lse, xs = ctc_head.fused_ctc_head(te, tw, tb, T(z))
    tg = torch.autograd.grad((lse, xs), (te, tw, tb), (T(g_lse), T(g_xs)))

    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xs.detach().numpy(), np.asarray(jxs), rtol=1e-5, atol=1e-5)
    for a, c in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-4, atol=1e-5)
    assert not tg[0][2, 15:].any()  # exactly zero where the cotangents are zero
    assert ctc_head.KERNEL.launches == 0


def test_head_label_outside_the_vocabulary_selects_nothing():
    """As a one-hot of it would: value 0 and no gradient (the JAX kernel's
    padded columns are not part of its contract, so only -1 is compared)."""
    e, w, b, _ = _head_inputs()
    z = np.array([[0, 5, 0], [0, 37, 0], [0, -1, 0]], np.int32)
    tw = T(w).requires_grad_(True)
    _, xs = ctc_head.fused_ctc_head(T(e), tw, T(b), T(z))
    _, jxs = jax_head(jnp.asarray(e), jnp.asarray(w), jnp.asarray(b), jnp.asarray(z))
    np.testing.assert_allclose(xs[[0, 2]].detach().numpy(), np.asarray(jxs)[[0, 2], :, :3], rtol=1e-5, atol=1e-5)
    assert not xs[1:, :, 1].any()
    (gw,) = torch.autograd.grad(xs[1:, :, 1].sum(), tw, allow_unused=True)
    assert gw is None or not gw.any()


def _loss_inputs():
    e, w, b, ys = _head_inputs(B=4, Tn=25)
    xl = np.array([25, 20, 15, 4], np.int32)  # the last row is infeasible
    yl = np.array([6, 4, 0, 6], np.int32)
    return e, w, b, ys, xl, yl


@pytest.mark.parametrize("route", ["fused_head", "dense"])
def test_ctc_loss_matches_jax_and_torch_ctc_loss(route):
    e, w, b, ys, xl, yl = _loss_inputs()
    if route == "fused_head":
        jf = lambda e_, w_, b_: jctc.ctc_loss_fused_head(e_, w_, b_, jnp.asarray(ys), jnp.asarray(xl), jnp.asarray(yl), 0)
        tf = lambda e_, w_, b_: tctc.ctc_loss_fused_head(e_, w_, b_, T(ys), T(xl), T(yl), 0)
    else:
        jf = lambda e_, w_, b_: jctc.ctc_loss_fn(e_ @ w_ + b_, jnp.asarray(ys), jnp.asarray(xl), jnp.asarray(yl), 0)
        tf = lambda e_, w_, b_: tctc.ctc_loss_fn(e_ @ w_ + b_, T(ys), T(xl), T(yl), 0)
    jv, jg = jax.value_and_grad(jf, argnums=(0, 1, 2))(jnp.asarray(e), jnp.asarray(w), jnp.asarray(b))

    te, tw, tb = (T(x).requires_grad_(True) for x in (e, w, b))
    loss = tf(te, tw, tb)
    tg = torch.autograd.grad(loss, (te, tw, tb))
    np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-5)
    for a, c in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-4, atol=1e-5)
    assert not tg[0][3].any()  # the infeasible row: loss 0, gradient exactly 0

    # the reference's native loss: sum over the batch / B, zero_infinity
    te2, tw2, tb2 = (T(x).requires_grad_(True) for x in (e, w, b))
    lp = torch.log_softmax(te2 @ tw2 + tb2, -1).transpose(0, 1)
    ref = F.ctc_loss(lp, T(ys).long(), T(xl).long(), T(yl).long(), blank=0,
                     reduction="sum", zero_infinity=True) / e.shape[0]
    rg = torch.autograd.grad(ref, (te2, tw2, tb2))
    np.testing.assert_allclose(loss.item(), ref.item(), rtol=1e-5)
    for a, c in zip(tg, rg):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-4, atol=1e-5)


def test_per_utterance_ctc_loss_matches_jax():
    lp, labels, xlens, ylens = _lattice_inputs(seed=3)
    ref = jctc.ctc_loss(jnp.asarray(lp), jnp.asarray(labels), jnp.asarray(xlens), jnp.asarray(ylens))
    out = tctc.ctc_loss(T(lp), T(labels), T(xlens), T(ylens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)
    assert out[2].item() == 0.0  # zero_infinity
    raw = tctc.ctc_loss(T(lp), T(labels), T(xlens), T(ylens), zero_infinity=False)
    assert raw[2].item() > -LOG_0 / 2


@pytest.mark.parametrize("i", range(4))
def test_forced_align_matches_fixture_and_jax(i):
    """The reference aligner's paths (fixtures_ctc_align.npz) and the JAX
    function's, exactly: alignments are integers."""
    fx = np.load(os.path.join(FIXDIR, "fixtures_ctc_align.npz"))
    lp, el, ys, yl, al = (fx[f"{k}{i}"] for k in ("lp", "el", "ys", "yl", "al"))
    out = tctc.ctc_forced_align(T(lp), T(el), T(ys), T(yl), blank_id=0)
    ref = jctc.ctc_forced_align(
        jnp.asarray(lp), jnp.asarray(el, jnp.int32), jnp.asarray(ys, jnp.int32),
        jnp.asarray(yl, jnp.int32), blank_id=0,
    )
    assert out.dtype == torch.int32
    assert np.array_equal(out.numpy(), np.asarray(ref))
    assert np.array_equal(out.numpy(), al)


def test_flip_by_length_matches_jax():
    from emoasr_tpu.ops.common import flip_by_length as jflip

    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 4)).astype(np.float32)
    lens = np.array([7, 3, 1], np.int32)
    np.testing.assert_array_equal(
        flip_by_length(T(x), T(lens)).numpy(), np.asarray(jflip(jnp.asarray(x), jnp.asarray(lens)))
    )
