"""K6's plain version (ops/lm_step.py::bert_layer_step_indirect_plain, what
the wrapper runs on CPU tensors) against the JAX package's fused LM layer
step (`ops/lm_step_pallas.py::fused_bert_layer_step_indirect`, Pallas
interpret mode, as tests/test_lm_step_pallas.py runs it) and against the
port's dense route (`BertLayer.step_indirect(fused=False)`).

Sizes: D = 16 to 32, 2 or 4 heads, F = 40 to 64, W = 1 to 10, Lc = 6 to
12; weights and inputs from numpy seeds.  Tolerance 1e-5 (f32, the same
arithmetic in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emoasr_tpu.ops import lm_step_pallas as jls
from emoasr_tpu_torch.models.lm.bert import BertLayer
from emoasr_tpu_torch.ops import lm_step
from emoasr_tpu_torch.ops.lm_step import WEIGHT_NAMES, erf_f32, gelu_erf_f32

TOL = 1e-5


def _weights(rng, D, F):
    """The step's weights as the JAX package shapes them: 2-D kernels
    (in, out), 1-D biases and LayerNorm scales."""
    shapes = {"wq": (D, D), "wk": (D, D), "wv": (D, D), "wo": (D, D), "wi": (D, F), "wo2": (F, D)}
    w = {}
    for n in WEIGHT_NAMES:
        if n in shapes:
            w[n] = (rng.normal(size=shapes[n]) / np.sqrt(shapes[n][0])).astype(np.float32)
        elif n.endswith("_s"):
            w[n] = (1.0 + 0.1 * rng.normal(size=D)).astype(np.float32)
        else:
            out = F if n == "bi" else D
            w[n] = (0.1 * rng.normal(size=out)).astype(np.float32)
    return w


def _port_layer(w, H, D, F):
    """A port `BertLayer` holding the weights `w` (its `_step_weights()`
    gives them back)."""
    layer = BertLayer(H, D, F, 0.0, 0.0).eval()
    sa, ao = layer.attention.self, layer.attention.output
    pairs = [(sa.query, "wq", "bq"), (sa.key, "wk", "bk"), (sa.value, "wv", "bv"), (ao.dense, "wo", "bo"),
             (layer.intermediate.dense, "wi", "bi"), (layer.output.dense, "wo2", "bo2")]
    with torch.no_grad():
        for lin, k, b in pairs:
            lin.weight.copy_(torch.from_numpy(w[k].T))
            lin.bias.copy_(torch.from_numpy(w[b]))
        for ln, s, b in ((ao.LayerNorm, "ln1_s", "ln1_b"), (layer.output.LayerNorm, "ln2_s", "ln2_b")):
            ln.weight.copy_(torch.from_numpy(w[s]))
            ln.bias.copy_(torch.from_numpy(w[b]))
    return layer


def _case(seed, Bu, W, L, H, D, F, uniform_pos=False):
    """One step's inputs: `pos` from 0 to L - 1 (per utterance when
    `uniform_pos`, else per row, with a 0 and an L - 1), and an ancestor
    table composed from random beam selections, anc[u, w, pos] = w."""
    rng = np.random.default_rng(seed)
    dk = D // H
    if uniform_pos:
        pos = np.repeat(rng.integers(0, L, size=(Bu, 1)), W, axis=1)
        pos[0] = 0
    else:
        pos = rng.integers(0, L, size=(Bu, W))
        pos.reshape(-1)[0], pos.reshape(-1)[-1] = 0, L - 1
    anc = np.repeat(np.arange(W)[None, :, None], Bu, 0).repeat(L, 2)
    for step in range(1, L):
        parent = rng.integers(0, W, size=(Bu, W))
        anc[:, :, :step] = np.take_along_axis(anc[:, :, :step], parent[:, :, None], axis=1)
    anc[np.arange(Bu)[:, None], np.arange(W)[None, :], pos] = np.arange(W)[None, :]
    return dict(h=rng.normal(size=(Bu, W, D)).astype(np.float32),
                ck=rng.normal(size=(Bu, W, L, H, dk)).astype(np.float32),
                cv=rng.normal(size=(Bu, W, L, H, dk)).astype(np.float32),
                pos=pos.astype(np.int32), anc=anc.astype(np.int32), w=_weights(rng, D, F))


def _jax(c):
    return [np.asarray(x) for x in jls.fused_bert_layer_step_indirect(
        jnp.asarray(c["h"]), jnp.asarray(c["ck"]), jnp.asarray(c["cv"]), jnp.asarray(c["pos"]),
        jnp.asarray(c["anc"]), {k: jnp.asarray(v) for k, v in c["w"].items()}, interpret=True)]


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=tol, rtol=0)


CASES = [
    (2, 4, 9, 2, 32, 64),
    (3, 1, 6, 4, 32, 48),  # W = 1, Bu not a multiple of anything
    (2, 10, 12, 2, 16, 40),  # W = 10, as the L3-3 beam
    (2, 17, 7, 2, 16, 40),  # beams wider than the CUDA kernel's row group of 16
    (1, 20, 6, 2, 16, 40),
    (2, 33, 6, 2, 16, 40),
]


@pytest.mark.parametrize("Bu,W,L,H,D,F", CASES)
def test_plain_matches_jax_kernel(Bu, W, L, H, D, F):
    c = _case(Bu * 100 + W, Bu, W, L, H, D, F)
    t = {k: torch.from_numpy(v) for k, v in c["w"].items()}
    args = [torch.from_numpy(c[k]) for k in ("h", "ck", "cv", "pos", "anc")]
    got = lm_step.bert_layer_step_indirect_plain(*args, t)
    wrapped = lm_step.fused_bert_layer_step_indirect(*args, t)  # CPU tensors: the plain version
    for a, b, r in zip(got, wrapped, _jax(c)):
        assert torch.equal(a, b)
        _close(a, r)
    assert lm_step.KERNEL.launches == 0 and lm_step.KERNEL._lib is None


@pytest.mark.parametrize("Bu,W,L,H,D,F", CASES)
def test_fused_layer_step_matches_dense_route(Bu, W, L, H, D, F):
    """`step_indirect(fused=True)` (the plain step, then the cache writes)
    against `step_indirect(fused=False)` (write, then attend): the same y
    and the same caches afterwards."""
    c = _case(Bu * 10 + W, Bu, W, L, H, D, F, uniform_pos=True)
    layer = _port_layer(c["w"], H, D, F)
    out = {}
    for fused in (False, True):
        ck, cv = torch.from_numpy(c["ck"].copy()), torch.from_numpy(c["cv"].copy())
        with torch.no_grad():
            y, ck, cv = layer.step_indirect(torch.from_numpy(c["h"]), ck, cv, torch.from_numpy(c["pos"]),
                                            torch.from_numpy(c["anc"]), fused=fused)
        out[fused] = (y, ck, cv)
    for a, b in zip(out[False], out[True]):
        _close(a, b)
    _close(out[True][0], _jax(c)[0])


def test_episode_with_random_parents_matches_jax_kernel():
    """Seven label-synchronous steps of one layer with random parent
    permutations composed into `anc`: the port's fused step (plain version,
    then its cache writes) against the JAX kernel followed by the JAX
    caller's writes (bert.py:221-229)."""
    Bu, W, L, H, D, F = 2, 3, 8, 2, 32, 64
    rng = np.random.default_rng(9)
    w = _weights(rng, D, F)
    layer = _port_layer(w, H, D, F)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    dk = D // H
    ck = torch.zeros(Bu, W, L, H, dk)
    cv = torch.zeros(Bu, W, L, H, dk)
    jck, jcv = jnp.zeros((Bu, W, L, H, dk)), jnp.zeros((Bu, W, L, H, dk))
    anc = np.zeros((Bu, W, L), np.int32)
    bidx, widx = np.arange(Bu)[:, None], np.arange(W)[None, :]
    for t in range(7):
        h = rng.normal(size=(Bu, W, D)).astype(np.float32)
        pos = np.full((Bu, W), t, np.int32)
        anc[bidx, widx, pos] = widx
        with torch.no_grad():
            y, ck, cv = layer.step_indirect(torch.from_numpy(h), ck, cv, torch.from_numpy(pos),
                                            torch.from_numpy(anc.copy()), fused=True)
        jy, kn, vn = jls.fused_bert_layer_step_indirect(
            jnp.asarray(h), jck, jcv, jnp.asarray(pos), jnp.asarray(anc), jw, interpret=True)
        jck = jck.at[bidx, widx, pos].set(kn)
        jcv = jcv.at[bidx, widx, pos].set(vn)
        _close(y, jy)
        anc = np.take_along_axis(anc, rng.integers(0, W, size=(Bu, W))[:, :, None], axis=1)
    _close(ck, jck)
    _close(cv, jcv)


def test_erf_is_the_jax_kernels_polynomial():
    """The port's copy of XLA's f32 erf gives the JAX kernel's values, and
    the exact gelu it feeds is torch's own within f32 rounding."""
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    _close(erf_f32(torch.from_numpy(x)), jls._erf_f32(jnp.asarray(x)), 1e-7)
    _close(gelu_erf_f32(torch.from_numpy(x)), torch.nn.functional.gelu(torch.from_numpy(x)), 1e-6)
