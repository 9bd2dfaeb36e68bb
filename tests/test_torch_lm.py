"""The port's Transformer LM (models/lm/{bert,lm}.py) against the emoASR
outputs recorded in tests/fixtures_lm_transformer.npz and against the JAX
`TransformerLM` on the same weights.

Sizes: the fixture's (2 layers x 32, 4 heads, FF 64, V = 40, max_seq_len
24); the JAX comparisons 2 layers x 32, 2 heads, FF 64, V = 40,
max_seq_len 16, weights redrawn from numpy and carried to the port by
`utils/flax_import.py::lm_state_dict`.  Tolerances: 1e-4 against the
recorded outputs (what tests/test_lm.py holds the JAX LM to); 1e-5 against
the JAX modules (f32, the same arithmetic in another order)."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emoasr_tpu.config import config_from_dict as jax_config
from emoasr_tpu.models.lm.lm import TransformerLM as JaxTransformerLM
from emoasr_tpu.utils import torch_import as ti
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.models.lm.lm import LM, load_lm_state_dict
from emoasr_tpu_torch.utils.flax_import import lm_state_dict

FIXDIR = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5

LM_SMALL = dict(lm_type="transformer", vocab_size=40, hidden_size=32, num_layers=2,
                num_attention_heads=2, intermediate_size=64, max_seq_len=16, dropout_rate=0.0)


def random_lm_params(conf: dict, seed: int = 0) -> dict:
    """JAX `TransformerLM` params with every leaf redrawn from numpy:
    kernels ~ N(0, 1/fan_in), embeddings ~ N(0, 1), biases ~ N(0, 0.1^2),
    norm scales ~ 1 + N(0, 0.1^2)."""
    cfg = jax_config(conf)
    shapes = jax.eval_shape(lambda: JaxTransformerLM(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3), jnp.int32), jnp.array([3])))["params"]
    rng = np.random.default_rng(seed)

    def redraw(path, x):
        name, shape = path[-1].key, np.shape(x)
        if name == "kernel":
            return (rng.normal(size=shape) / math.sqrt(shape[0])).astype(np.float32)
        if name == "embedding":
            return rng.normal(size=shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(redraw, shapes)


def build_lm(cfg, sd) -> LM:
    """The port's `LM` on the CPU, in eval mode, with the weights of `sd`."""
    model = LM(cfg)
    load_lm_state_dict(model, sd)
    return model.eval()


def lm_pair(conf: dict, seed: int = 0):
    """(JAX module, its variables, the port's `LM` on the CPU) on the same
    weights."""
    params = random_lm_params(conf, seed)
    port = build_lm(config_from_dict(conf), lm_state_dict(params, config_from_dict(conf)))
    return JaxTransformerLM(jax_config(conf)), {"params": params}, port


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=tol, rtol=0)


def _tokens(seed, B, L, V=40):
    rng = np.random.default_rng(seed)
    ys = rng.integers(3, V, size=(B, L))
    ylens = np.sort(rng.integers(2, L + 1, size=B))[::-1].copy()
    ylens[0] = L
    return ys, ylens


def test_lm_matches_recorded_emoasr_outputs():
    fx = np.load(os.path.join(FIXDIR, "fixtures_lm_transformer.npz"))
    cfg = config_from_dict(dict(vocab_size=40, hidden_size=32, num_layers=2, num_attention_heads=4,
                                intermediate_size=64, max_seq_len=24, mask_id=39, lm_type="transformer"))
    sd = {k[4:]: torch.from_numpy(fx[k]) for k in fx.files if k.startswith("sd::")}
    assert any(k.startswith("transformer.bert.pooler.") for k in sd)  # present, and dropped
    model = build_lm(cfg, sd)
    ys, ylens = torch.from_numpy(fx["ys"]), torch.from_numpy(fx["ylens"])
    with torch.no_grad():
        logits = model.lm.logits(ys, ylens)
        scores = model.score(ys, ylens)
        preds, _ = model.predict(ys, ylens)
    for b, n in enumerate(fx["ylens"]):
        np.testing.assert_allclose(logits[b, :n].numpy(), fx["logits"][b, :n], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), fx["scores"], rtol=1e-4)
    np.testing.assert_allclose(preds.numpy(), fx["preds"], rtol=1e-3, atol=1e-5)

    # the same file with the facade's `lm.` prefix loads the same weights
    prefixed = build_lm(cfg, {f"lm.{k}": v for k, v in sd.items()})
    with torch.no_grad():
        assert torch.equal(prefixed.lm.logits(ys, ylens), logits)
    # strict about every key but the pooler's
    missing = {k: v for k, v in sd.items() if not k.endswith("layer.1.output.dense.bias")}
    with pytest.raises(RuntimeError, match="Missing key"):
        load_lm_state_dict(LM(cfg), missing)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_lm_state_dict(LM(cfg), dict(sd, **{"transformer.bert.extra.weight": torch.zeros(1)}))


def test_lm_forward_predict_and_score_match_jax():
    jm, jv, port = lm_pair(LM_SMALL, seed=1)
    ys, ylens = _tokens(2, B=4, L=12)
    jys, jyl = jnp.asarray(ys), jnp.asarray(ylens)
    tys, tyl = torch.from_numpy(ys), torch.from_numpy(ylens)
    with torch.no_grad():
        logits = port.lm.logits(tys, tyl)
        preds, st = port.predict(tys, tyl)
        scores = port.score(tys, tyl)
    ref = jm.apply(jv, jys, jyl)
    for b, n in enumerate(ylens):
        _close(logits[b, :n], np.asarray(ref)[b, :n])
    jpreds, _ = jm.apply(jv, jys, jyl, method=JaxTransformerLM.predict)
    _close(preds, jpreds)
    assert st is None
    _close(scores, jm.apply(jv, jys, jyl, method=JaxTransformerLM.score))


def test_predict_step_matches_jax_and_the_full_prefix():
    """Cached steps over a whole sequence: each step's log-probs equal the
    JAX step's and the stateless `predict` on the prefix."""
    jm, jv, port = lm_pair(LM_SMALL, seed=3)
    B, L = 3, 9
    ys, _ = _tokens(4, B, L)
    caches = port.init_cache(B, L)
    jcaches = jm.apply(jv, B, L, method=JaxTransformerLM.init_cache)
    for t in range(L):
        tok, pos = ys[:, t], np.full((B,), t)
        with torch.no_grad():
            lp, caches = port.predict_step(torch.from_numpy(tok), torch.from_numpy(pos), caches)
            full, _ = port.predict(torch.from_numpy(ys[:, : t + 1]), torch.full((B,), t + 1))
        jlp, jcaches = jm.apply(jv, jnp.asarray(tok), jnp.asarray(pos), jcaches,
                                method=JaxTransformerLM.predict_step)
        _close(lp, jlp)
        _close(lp, full)
    for (k, v), (jk, jv_) in zip(caches, jcaches):
        _close(k, jk)
        _close(v, jv_)


@pytest.mark.parametrize("fused", [False, True])
def test_predict_step_indirect_matches_jax(fused):
    """Ancestor-indirect steps with random beam permutations (the search's
    protocol: anc[b, w, pos] = w before the step, parents composed into anc
    after it): the port's dense route and its fused step (the kernel's plain
    version on CPU tensors) against the JAX dense route."""
    import emoasr_tpu_torch.models.lm.bert as bert_mod

    jm, jv, port = lm_pair(LM_SMALL, seed=5)
    B, W, Lc, steps = 2, 3, 10, 7
    rng = np.random.default_rng(6)
    caches = [tuple(x.reshape(B, W, Lc, *x.shape[2:]) for x in kv) for kv in port.init_cache(B * W, Lc)]
    jcaches = [tuple(x.reshape(B, W, Lc, *x.shape[2:]) for x in kv)
               for kv in jm.apply(jv, B * W, Lc, method=JaxTransformerLM.init_cache)]
    anc = np.zeros((B, W, Lc), np.int32)
    bidx, widx = np.arange(B)[:, None], np.arange(W)[None, :]
    bert_mod.FUSED_INDIRECT_STEP = fused
    try:
        for t in range(steps):
            tok = rng.integers(3, 40, size=(B, W))
            pos = np.full((B, W), t)  # label-synchronous: every row writes column t at step t
            anc[bidx, widx, pos] = widx
            with torch.no_grad():
                lp, caches = port.predict_step_indirect(
                    torch.from_numpy(tok), torch.from_numpy(pos), caches, torch.from_numpy(anc.copy()))
            jlp, jcaches = jm.apply(jv, jnp.asarray(tok), jnp.asarray(pos), jcaches, jnp.asarray(anc),
                                    method=JaxTransformerLM.predict_step_indirect)
            _close(lp, jlp)
            parent = rng.integers(0, W, size=(B, W))
            anc = np.take_along_axis(anc, parent[:, :, None], axis=1)
    finally:
        bert_mod.FUSED_INDIRECT_STEP = None
    for (k, v), (jk, jv_) in zip(caches, jcaches):
        _close(k, jk)
        _close(v, jv_)


def test_flax_import_round_trips():
    """flax params -> the port's `state_dict` -> flax params (the JAX
    importer `bert_masked_lm`) gives the same tree back, and the port module
    holds exactly the keys `lm_state_dict` writes."""
    params = random_lm_params(LM_SMALL, seed=7)
    cfg = config_from_dict(LM_SMALL)
    sd = lm_state_dict(params, cfg)
    assert set(sd) == set(LM(cfg).lm.state_dict())
    back = ti.bert_masked_lm({k: v.numpy() for k, v in sd.items()}, cfg.num_layers, "transformer.")
    flat = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(leaf))
    # the facade's tree maps the same way
    assert all(torch.equal(sd[k], v) for k, v in lm_state_dict({"lm": params}, cfg).items())
