"""Port `fused_self_attention` (its plain version, which CPU tensors take)
against the JAX package's `fused_self_attention` (Pallas in interpret mode
off-TPU; its pure-JAX fallback when dropout is on).

Tolerances: f32 atol 1e-5 (the two frameworks sum in different orders);
bf16 atol 2e-2 (that of tests/test_attention_pallas.py: P and the output
are rounded to bf16 on both sides)."""

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from emoasr_tpu.ops.attention_pallas import fused_self_attention as jax_fsa
from emoasr_tpu_torch.ops import attention
from emoasr_tpu_torch.ops.attention import fused_self_attention

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, B, T, H, D, dtype):
    rng = np.random.default_rng(seed)
    mk = lambda: rng.normal(size=(B, T, H, D)).astype(np.float32)
    q, k, v = mk(), mk(), mk()
    if dtype == "bfloat16":
        q, k, v = (x.astype(ml_dtypes.bfloat16).astype(np.float32) for x in (q, k, v))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return (
        [torch.from_numpy(x).to(tdt) for x in (q, k, v)],
        [jnp.asarray(x).astype(jdt) for x in (q, k, v)],
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_kernel(dtype):
    B, T, H, D = 4, 37, 4, 16
    (q, k, v), (jq, jk, jv) = _inputs(0, B, T, H, D, dtype)
    lens = np.array([37, 20, 0, 1], np.int32)  # full, ragged, empty, one key
    scale = 1.0 / math.sqrt(D)
    out = fused_self_attention(q, k, v, torch.from_numpy(lens), scale=scale)
    ref = jax_fsa(jq, jk, jv, jnp.asarray(lens), jnp.zeros((), jnp.int32), scale=scale)
    assert out.dtype == v.dtype and out.shape == (B, T, H, D)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), atol=TOL[dtype], rtol=0
    )
    assert not out[2].float().abs().any()  # lens == 0: all-zero output
    assert attention.KERNEL.launches == 0  # CPU tensors take the plain version


def test_bias_matches_jax_kernel():
    B, T, H, D = 2, 29, 2, 8
    (q, k, v), (jq, jk, jv) = _inputs(1, B, T, H, D, "float32")
    bias = np.random.default_rng(2).normal(size=(B, H, T, T)).astype(np.float32)
    lens = np.array([29, 13], np.int32)
    scale = 1.0 / math.sqrt(D)
    out = fused_self_attention(
        q, k, v, torch.from_numpy(lens), scale=scale, bias=torch.from_numpy(bias)
    )
    ref = jax_fsa(
        jq, jk, jv, jnp.asarray(lens), jnp.zeros((), jnp.int32), scale=scale,
        bias=jnp.asarray(bias),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL["float32"], rtol=0)


def test_dropout_same_mask_matches_jax():
    """Dropout with the keep mask JAX draws fed to the port."""
    B, T, H, D = 2, 23, 2, 8
    (q, k, v), (jq, jk, jv) = _inputs(3, B, T, H, D, "float32")
    lens = np.array([23, 9], np.int32)
    scale, rate, seed = 1.0 / math.sqrt(D), 0.3, 1234
    ref = jax_fsa(
        jq, jk, jv, jnp.asarray(lens), jnp.asarray(seed, jnp.int32), scale=scale,
        dropout_rate=rate, deterministic=False,
    )
    # the JAX package's off-TPU dropout mask (attention_pallas._fallback)
    keep = jax.random.bernoulli(
        jax.random.PRNGKey(jnp.asarray(seed, jnp.int32).astype(jnp.uint32)),
        1.0 - rate, (B, H, T, T),
    )
    out = fused_self_attention(
        q, k, v, torch.from_numpy(lens), scale=scale, dropout_rate=rate,
        deterministic=False, dropout_mask=torch.from_numpy(np.array(keep)),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL["float32"], rtol=0)
    # deterministic: dropout off whatever the rate
    out_det = fused_self_attention(
        q, k, v, torch.from_numpy(lens), scale=scale, dropout_rate=rate,
    )
    ref_det = jax_fsa(jq, jk, jv, jnp.asarray(lens), jnp.zeros((), jnp.int32), scale=scale)
    np.testing.assert_allclose(out_det.numpy(), np.asarray(ref_det), atol=TOL["float32"], rtol=0)


def test_dropout_from_generator_keeps_expected_share():
    B, T, H, D = 2, 64, 2, 8
    (q, k, v), _ = _inputs(4, B, T, H, D, "float32")
    lens = torch.tensor([64, 64])
    g = torch.Generator().manual_seed(0)
    v1 = torch.ones_like(v)
    out = fused_self_attention(
        q, k, v1, lens, scale=0.3, dropout_rate=0.5, deterministic=False, generator=g,
    )
    # rows of P sum to 1; kept entries are doubled, so the mean stays ~1
    assert abs(out.mean().item() - 1.0) < 0.05


def _grads_both(q, k, v, jq, jk, jv, lens, d_out, scale, rate=0.0, seed=0, keep=None):
    """(out, dq, dk, dv) of the port and of `jax.vjp` through the JAX function."""
    jlens, jseed = jnp.asarray(lens), jnp.asarray(seed, jnp.int32)
    jout, jvjp = jax.vjp(
        lambda a, b, c: jax_fsa(a, b, c, jlens, jseed, scale=scale, dropout_rate=rate,
                                deterministic=rate == 0.0),
        jq, jk, jv,
    )
    ref = (jout, *jvjp(jnp.asarray(d_out)))
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = fused_self_attention(
        q, k, v, torch.from_numpy(lens), scale=scale, dropout_rate=rate,
        deterministic=rate == 0.0, dropout_mask=keep,
    )
    got = (out.detach(), *torch.autograd.grad(out, (q, k, v), torch.from_numpy(d_out)))
    return got, ref


def test_gradients_match_jax_kernel():
    """dq, dk, dv against `jax.grad` through the Pallas backward kernel
    (interpret mode), f32, ragged lens with a `lens == 0` row.  atol 1e-5:
    sums over up to 37 keys or queries in two orders."""
    B, T, H, D = 4, 37, 4, 16
    (q, k, v), (jq, jk, jv) = _inputs(5, B, T, H, D, "float32")
    lens = np.array([37, 20, 0, 1], np.int32)
    d_out = np.random.default_rng(6).normal(size=(B, T, H, D)).astype(np.float32)
    got, ref = _grads_both(q, k, v, jq, jk, jv, lens, d_out, 1.0 / math.sqrt(D))
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL["float32"], rtol=0, err_msg=name)
    assert not got[1][2].any() and not got[2][2].any() and not got[3][2].any()  # lens == 0
    assert not got[2][1, 20:].any() and not got[3][1, 20:].any()  # dk, dv at masked keys
    assert attention.KERNEL.launches == 0


def test_dropout_gradients_same_mask_match_jax():
    """Forward and backward with dropout, one keep mask on both sides (the
    JAX side goes through `_fallback`'s arithmetic with the mask it draws)."""
    B, T, H, D = 2, 23, 2, 8
    (q, k, v), (jq, jk, jv) = _inputs(7, B, T, H, D, "float32")
    lens = np.array([23, 9], np.int32)
    d_out = np.random.default_rng(8).normal(size=(B, T, H, D)).astype(np.float32)
    rate, seed = 0.3, 4321
    keep = jax.random.bernoulli(
        jax.random.PRNGKey(jnp.asarray(seed, jnp.int32).astype(jnp.uint32)), 1.0 - rate, (B, H, T, T))
    got, ref = _grads_both(q, k, v, jq, jk, jv, lens, d_out, 1.0 / math.sqrt(D), rate, seed,
                           torch.from_numpy(np.array(keep)))
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL["float32"], rtol=0, err_msg=name)


def test_dropout_seed_is_drawn_from_the_generator():
    """One fresh seed per call: two calls draw two seeds, and a generator
    seeded alike draws them again."""
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a, b = attention.draw_seed(g1), attention.draw_seed(g1)
    assert a != b and 0 <= a < 2 ** 62
    assert (attention.draw_seed(g2), attention.draw_seed(g2)) == (a, b)
    lo, hi, threshold, inv = attention._dropout_args(0.1, (5 << 32) | 7)
    assert (lo, hi, threshold) == (7, 5, int(0.1 * 2 ** 32)) and inv == pytest.approx(1 / 0.9)
    assert attention._dropout_args(0.0, 99) == (0, 0, 0, 1.0)
