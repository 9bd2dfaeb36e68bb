"""The port's joint-CTC attention beam search against the JAX package's, on
the same weights (carried across by `utils/flax_import.py`) and inputs.

Whole-pipeline cases go through `build_decode_fn` on both sides (Conformer
encoder, cross K/V, the step route, CTC caps, the search); search-level cases
call `attention_beam_search` on both sides with the re-encode `step_fn`.
Sizes: 1-2 layers, d=32, V=50, T'=11, W<=4.  Hypotheses and lengths must be
equal; scores within atol 1e-4 (sums of a dozen f32 log-probabilities and
prefix-score differences computed by two frameworks).  The JAX fused steps
run in Pallas interpret mode, the port's their plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emoasr_tpu.config import config_from_dict as jax_config
from emoasr_tpu.eval.decode import build_decode_fn as jax_build_decode_fn
from emoasr_tpu.models.asr import ASR as JaxASR
from emoasr_tpu.models.decoders.transformer import TransformerDecoder as JaxDecoder
from emoasr_tpu.models.layers import make_pad_mask as jax_pad_mask
from emoasr_tpu.search.attention_beam import attention_beam_search as jax_beam
from emoasr_tpu_torch.eval.decode import build_decode_fn, ctc_len_caps
from emoasr_tpu_torch.models.layers import make_pad_mask
from emoasr_tpu_torch.ops import decoder_step as ds
from emoasr_tpu_torch.ops import topk
from emoasr_tpu_torch.search import attention_beam as ab
from test_torch_conformer import L3_SMALL, port_model, random_l3_params

BASE = dict(L3_SMALL, enc_num_layers=1)
V = 50
DEAD_CUT = -1e29


def _weights(eos_bias: float, seed: int = 0):
    params, stats = random_l3_params(BASE, seed)
    params["decoder"]["output"]["bias"][2] += eos_bias  # how readily a beam ends
    return params, stats


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(3, 50, 20)).astype(np.float32), np.array([50, 41, 33], np.int32)


def _same(got, ref, name=""):
    hyps, lens, scores = (np.asarray(x) for x in ref)
    g_hyps, g_lens, g_scores = (x.numpy() for x in got)
    np.testing.assert_array_equal(g_scores > DEAD_CUT, scores > DEAD_CUT, err_msg=name)
    np.testing.assert_array_equal(g_lens, lens, err_msg=name)
    np.testing.assert_array_equal(g_hyps, hyps, err_msg=name)
    live = scores > DEAD_CUT
    np.testing.assert_allclose(g_scores[live], scores[live], atol=1e-4, rtol=0, err_msg=name)


def _both(conf, weights, beam, len_w, ctc_w, top1=False):
    params, stats = weights
    xs, xlens = _batch()
    jcfg = jax_config(conf)
    jfn = jax_build_decode_fn(JaxASR(jcfg), {"params": params, "batch_stats": stats}, jcfg, beam,
                              len_w, ctc_w, top1=top1)
    model = port_model(conf, params, stats)
    fn = build_decode_fn(model, model.cfg, beam, len_w, ctc_w, top1=top1, device="cpu")
    return fn, jfn, xs, xlens


@pytest.mark.parametrize("mode", ["dense", "fused", "indirect", "fused_indirect"])
def test_beam_matches_jax_in_every_step_mode(mode):
    """Joint CTC 0.3, length weight 2 (the L3-1 operating point), beam 4,
    with `enc_fused_attn` on: hyps and lens equal, scores within 1e-4; then
    the same decode function rebound to length weight 0."""
    conf = dict(BASE, dec_step_mode=mode, enc_fused_attn=True)
    fn, jfn, xs, xlens = _both(conf, _weights(3.0), 4, 2.0, 0.3)
    ref = jfn(jnp.asarray(xs), jnp.asarray(xlens))
    got = fn(xs, xlens)
    assert (got[2][:, 0] > DEAD_CUT).all() and got[0].shape == (3, 4, 14)
    _same(got, ref, mode)
    _same(fn.with_weights(None, 0.0)(xs, xlens),
          jfn.with_weights(None, 0.0)(jnp.asarray(xs), jnp.asarray(xlens)), f"{mode} len_w 0")
    assert ds.KERNEL.launches == 0 and ds.KERNEL_INDIRECT.launches == 0 and topk.KERNEL.launches == 0


@pytest.mark.parametrize("len_w", [0.0, 2.0])
def test_beam_without_ctc_matches_jax(len_w):
    """decode_ctc_weight 0 with `dec_step_mode: auto` (= indirect); the
    row caps then come from the auxiliary CTC head only under
    `decode_len_cap: on`, which is run too."""
    for cap in ("auto", "on"):
        conf = dict(BASE, decode_len_cap=cap)
        fn, jfn, xs, xlens = _both(conf, _weights(2.0, seed=1), 3, len_w, 0.0)
        _same(fn(xs, xlens), jfn(jnp.asarray(xs), jnp.asarray(xlens)), f"cap {cap}")


def test_forced_finalisation_at_row_caps_and_cap_off():
    """A model that never emits eos: with the CTC length caps every row
    returns W force-finalized hypotheses of exactly cap tokens; with
    `decode_len_cap: off` it returns nothing, as the reference does."""
    weights = _weights(-25.0, seed=2)
    fn, jfn, xs, xlens = _both(dict(BASE), weights, 3, 0.1, 0.3)
    ref = jfn(jnp.asarray(xs), jnp.asarray(xlens))
    got = fn(xs, xlens)
    _same(got, ref, "forced")
    model = port_model(dict(BASE), *weights)
    with torch.no_grad():
        eouts, elens, _ = model.encode(torch.from_numpy(xs), torch.from_numpy(xlens).long())
        caps = ctc_len_caps(model.cfg, torch.log_softmax(model.decoder.ctc.logits(eouts), -1), elens)
    hyps, lens, scores = (x.numpy() for x in got)
    assert (scores > DEAD_CUT).all()
    for b, cap in enumerate(caps.tolist()):
        assert (lens[b] == cap + 1).all()
        assert all((hyps[b, w, 1:lens[b, w]] != 2).all() for w in range(3))
    fn, jfn, xs, xlens = _both(dict(BASE, decode_len_cap="off"), weights, 3, 0.1, 0.3)
    got = fn(xs, xlens)
    _same(got, jfn(jnp.asarray(xs), jnp.asarray(xlens)), "cap off")
    assert (got[2].numpy() < DEAD_CUT).all()


def test_beam_width_one_masks_the_step_zero_eos():
    """An eos-hungry model at W = 1 (beam widths 0 and 1 are both the 1-wide
    beam for this decoder): the step-0 eos is masked, the single beam lives
    and ends at its next step."""
    fn, jfn, xs, xlens = _both(dict(BASE), _weights(25.0, seed=3), 0, 0.1, 0.3)
    got = fn(xs, xlens)
    _same(got, jfn(jnp.asarray(xs), jnp.asarray(xlens)), "W=1")
    hyps, lens, scores = (x.numpy() for x in got)
    assert hyps.shape[1] == 1 and (scores[:, 0] > DEAD_CUT).all()
    assert (lens[:, 0] == 3).all() and (hyps[:, 0, 1] != 2).all() and (hyps[:, 0, 2] == 2).all()


@pytest.mark.parametrize("ctc_w,len_w", [(0.0, 0.3), (0.3, 2.0)])
def test_top1_equals_the_full_search_best(ctc_w, len_w):
    """`top1` (need_results = 1): the same best hypothesis and score as the
    full search, on both sides."""
    weights = _weights(3.0, seed=4)
    fn1, jfn1, xs, xlens = _both(dict(BASE), weights, 4, len_w, ctc_w, top1=True)
    fn, _, _, _ = _both(dict(BASE), weights, 4, len_w, ctc_w)
    top, full = fn1(xs, xlens), fn(xs, xlens)
    ref = jfn1(jnp.asarray(xs), jnp.asarray(xlens))
    for b in range(3):
        n = int(full[1][b, 0])
        assert full[2][b, 0] > DEAD_CUT and int(top[1][b, 0]) == n == int(np.asarray(ref[1])[b, 0])
        assert torch.equal(top[0][b, 0, :n], full[0][b, 0, :n])
        np.testing.assert_array_equal(top[0][b, 0, :n].numpy(), np.asarray(ref[0])[b, 0, :n])
        np.testing.assert_allclose(top[2][b, 0].item(), full[2][b, 0].item(), atol=1e-5)
        np.testing.assert_allclose(top[2][b, 0].item(), float(np.asarray(ref[2])[b, 0]), atol=1e-4)


def test_reencode_route_and_stages_match_jax(monkeypatch):
    """The search itself, with the re-encode `step_fn` (no caches) and
    explicit `row_caps`, against the JAX search; then the port's staged loop
    (cache bounds 4, 7, 11 forced at this size) against its single stage, for
    the re-encode, cached and indirect routes."""
    params, stats = _weights(1.5, seed=5)
    model = port_model(dict(BASE), params, stats)
    dec = model.decoder
    jdec, jvars = JaxDecoder(jax_config(BASE)), {"params": params["decoder"]}
    rng = np.random.default_rng(5)
    B, T, W = 3, 10, 3
    eouts = rng.normal(size=(B, T, 32)).astype(np.float32)
    elens = np.array([10, 8, 6], np.int32)
    caps = np.array([5, 12, 7], np.int32)

    def jstep(h, l, eo, el):
        return jdec.apply(jvars, h, l, eo, jax_pad_mask(el, T)[:, None, None, :],
                          method=JaxDecoder.forward_one_step)

    jlp = jnp.asarray(np.asarray(jdec.apply(jvars, jnp.asarray(eouts), method=lambda m, e: m.ctc.logits(e))))
    jlp = jlp - jnp.log(jnp.exp(jlp).sum(-1, keepdims=True))
    ref = jax_beam(jnp.asarray(eouts), jnp.asarray(elens), jstep, vocab_size=V, beam_width=W, len_weight=0.2,
                   decode_ctc_weight=0.3, ctc_log_probs=jlp, max_decode_ylen=12, row_caps=jnp.asarray(caps))

    te, tl = torch.from_numpy(eouts), torch.from_numpy(elens).long()
    emask = make_pad_mask(tl, T)[:, None, None, :]

    def step(h, l, eo, el):
        return dec.forward_one_step(h, l, eo, make_pad_mask(el, T)[:, None, None, :])

    with torch.no_grad():
        lp = torch.log_softmax(dec.ctc.logits(te), -1)
        cross = dec.precompute_cross_kv(te)
        init = lambda n, L: dec.init_cache(n, L)
        cached = lambda t, p, c: dec.decode_step_cached(t, p, c, cross, emask, beam_width=W)
        indirect = lambda t, p, c, a: dec.decode_step_cached_indirect(t, p, c, a, cross, emask, beam_width=W)
        kw = dict(vocab_size=V, beam_width=W, len_weight=0.2, decode_ctc_weight=0.3, ctc_log_probs=lp,
                  max_decode_ylen=12, row_caps=torch.from_numpy(caps))
        routes = {"re-encode": dict(step_fn=step), "cached": dict(step_fn=None, cached_step=(init, cached)),
                  "indirect": dict(step_fn=None, cached_step=(init, cached, indirect))}
        base = {name: ab.attention_beam_search(te, tl, **r, **kw) for name, r in routes.items()}
        _same(base["re-encode"], ref, "re-encode")
        monkeypatch.setattr(ab, "STAGE_BOUNDS", (4, 7, 11))
        for name, r in routes.items():
            staged = ab.attention_beam_search(te, tl, **r, **kw)
            _same(staged, tuple(x.numpy() for x in base["re-encode"]), f"staged {name}")
