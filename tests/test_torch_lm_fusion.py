"""LM shallow fusion in the port (`search/common.py::make_lm_fusion`, the CTC
prefix beam, the attention beam) against the JAX package's, on the same
weights and inputs.

- The three fusion modes (stateless, cached, indirect) give the same
  log-probabilities over an episode of label-synchronous steps with random
  beam permutations, and the JAX stateless mode's.
- The CTC prefix beam with the cached LM (the mode it takes) equals the JAX
  beam: length weight 0.5, frames that repeat a token with and without a
  blank between, ragged lengths.
- The attention beam with joint CTC 0 and 0.3 and the LM in each mode
  equals the JAX search through `build_decode_fn` on both sides, with the
  stage bounds forced to (4, 8) so that the states grow twice and, in the
  cached and indirect modes, an LM bound of 6 so that the states stop
  growing and the position clamp `Lc - 1` is reached.

Sizes: LM 2 layers x 32, 2 heads, FF 64, V = 56 (more than the ASR's 50,
so the attention beam's `[:V]` slice is exercised), max_seq_len 16; ASR as
tests/test_torch_attention_beam.py (1 encoder layer, 2 decoder layers,
d = 32).  Hypotheses and lengths exact; scores atol 1e-4 (sums of a dozen
f32 log-probabilities from two frameworks), log-probabilities 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emoasr_tpu.config import config_from_dict as jax_config
from emoasr_tpu.eval.decode import build_decode_fn as jax_build_decode_fn
from emoasr_tpu.models.asr import ASR as JaxASR
from emoasr_tpu.search import attention_beam as jax_ab
from emoasr_tpu.search.common import make_lm_fusion as jax_make_lm_fusion
from emoasr_tpu.search.ctc_beam import ctc_beam_search as jax_ctc_beam
from emoasr_tpu_torch.eval.decode import build_decode_fn
from emoasr_tpu_torch.search import attention_beam as ab
from emoasr_tpu_torch.search.common import make_lm_fusion
from emoasr_tpu_torch.search.ctc_beam import ctc_beam_search
from test_torch_attention_beam import BASE, _batch, _same, _weights
from test_torch_conformer import port_model
from test_torch_lm import LM_SMALL, lm_pair

LM_CONF = dict(LM_SMALL, vocab_size=56)


@pytest.fixture(scope="module")
def lms():
    return lm_pair(LM_CONF, seed=21)


def test_three_modes_agree_over_an_episode(lms):
    jm, jv, port = lms
    B, W, steps, V = 2, 3, 8, 56
    rng = np.random.default_rng(22)
    fusions = {m: make_lm_fusion(port, 0.5, mode=m) for m in ("stateless", "cached", "indirect")}
    jfusion = jax_make_lm_fusion(jm, jv, 0.5, mode="stateless")
    states = {"stateless": None, "cached": fusions["cached"].init_states(B, W, 4),
              "indirect": fusions["indirect"].indirect.init_states(B, W, 4)}
    hyps = np.full((B, W, 12), 2, np.int64)
    for t in range(steps):
        lens = np.full((B, W), t + 1)
        th, tl = torch.from_numpy(hyps), torch.from_numpy(lens)
        if t == 4:  # a stage transition: the states grow on axis 2
            for m in ("cached", "indirect"):
                states[m] = ab.tree_map(lambda x: ab._grow(x, 9), states[m])
        with torch.no_grad():
            out = {"stateless": fusions["stateless"].predict_beams(th, tl, None),
                   "cached": fusions["cached"].predict_beams(th, tl, states["cached"]),
                   "indirect": fusions["indirect"].indirect.predict_beams(th, tl, states["indirect"])}
        ref, _ = jfusion.predict_beams(jnp.asarray(hyps), jnp.asarray(lens), None)
        for m, (lp, _) in out.items():
            assert lp.shape == (B, W, V)
            np.testing.assert_allclose(lp.numpy(), np.asarray(ref), atol=1e-5, rtol=0, err_msg=f"{m} step {t}")
        parent = torch.from_numpy(rng.integers(0, W, size=(B, W)))
        states["cached"] = ab.tree_map(lambda x: ab.gather_beams(x, parent), out["cached"][1])
        states["indirect"] = fusions["indirect"].indirect.gather_states(out["indirect"][1], parent)
        hyps = np.take_along_axis(hyps, parent.numpy()[:, :, None], axis=1)
        hyps[:, :, t + 1] = rng.integers(3, V, size=(B, W))


def _ctc_log_probs(seed, B=3, T=14, V=56):
    """Random CTC posteriors whose peaks repeat tokens: frames 2-3 and 5-6
    favour one token twice in a row, frames 8, 9, 10 favour a token, blank,
    the same token."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, V)).astype(np.float32)
    for b in range(B):
        a, c = rng.integers(3, V, size=2)
        x[b, [2, 3], a] += 4.0
        x[b, [5, 6], c] += 3.0
        x[b, [8, 10], a] += 3.0
        x[b, 9, 0] += 3.0
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def test_ctc_beam_with_cached_lm_matches_jax(lms):
    jm, jv, port = lms
    lp = _ctc_log_probs(23)
    elens = np.array([14, 11, 7], np.int32)
    ref = jax_ctc_beam(jnp.asarray(lp), jnp.asarray(elens), 4, 0, 2, 0.5,
                       lm=jax_make_lm_fusion(jm, jv, 0.5, mode="cached"))
    with torch.no_grad():
        got = ctc_beam_search(torch.from_numpy(lp), torch.from_numpy(elens).long(), 4, 0, 2, 0.5,
                              lm=make_lm_fusion(port, 0.5, mode="cached"))
    _same(got, ref, "ctc beam + LM")
    hyps = got[0].numpy()
    # the rule under test: the best beams hold repeated tokens
    assert any(int(h[i]) == int(h[i + 1]) for h in hyps[:, 0] for i in range(1, len(h) - 1) if h[i] > 2)


@pytest.mark.parametrize("ctc_w", [0.0, 0.3])
@pytest.mark.parametrize("mode", ["indirect", "cached", "stateless"])
def test_attention_beam_with_lm_matches_jax(lms, monkeypatch, mode, ctc_w):
    jm, jv, port = lms
    params, stats = _weights(-2.0, seed=24)
    # seed weights seldom end a beam: the step budget (12, the margin)
    # force-finalises them, with and without joint CTC
    conf = dict(BASE, max_decode_ylen=12, decode_len_cap="on")
    monkeypatch.setattr(jax_ab, "STAGE_BOUNDS", (4, 8))
    monkeypatch.setattr(ab, "STAGE_BOUNDS", (4, 8))
    max_len = None if mode == "stateless" else 6
    jcfg = jax_config(conf)
    jfn = jax_build_decode_fn(JaxASR(jcfg), {"params": params, "batch_stats": stats}, jcfg, 3, 0.3, ctc_w,
                              jax_make_lm_fusion(jm, jv, 0.5, max_len=max_len, mode=mode))
    model = port_model(conf, params, stats)
    fn = build_decode_fn(model, model.cfg, 3, 0.3, ctc_w, lm=make_lm_fusion(port, 0.5, max_len, mode),
                         device="cpu")
    xs, xlens = _batch(25)
    got = fn(xs, xlens)
    _same(got, jfn(jnp.asarray(xs), jnp.asarray(xlens)), f"{mode} ctc {ctc_w}")
    assert int(got[1].max()) > 8  # past the last stage transition and the LM's bound
