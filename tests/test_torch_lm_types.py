"""The port's BERT and RNN LMs (models/lm/lm.py), their weight import, the
chunked pseudo-log-likelihood, and RNN-LM shallow fusion in the three beams,
against the emoASR outputs recorded in tests/fixtures_lm_{transformer,bert,
rnn}.npz and against the JAX package on the same weights.

- Each LM type's logits, masked-LM loss, `score` (and the RNN LM's
  one-token `predict` and states) against the recorded outputs.
- BERT and RNN LMs against the JAX modules: logits, loss, `score`,
  `predict`, in train mode with dropout 0 as in eval mode; `lm_state_dict`
  gives every key of the port's module, and the JAX importers take its
  names back to the same tree.
- The pseudo-log-likelihood in chunks (one copy a chunk, and all at once)
  against the JAX `test_ppl._masked_nll` over the whole (B L, L) batch.
- RNN-LM fusion at weight 0.5 in the CTC prefix beam, the attention beam
  (joint CTC 0.3) and the RNN-T ALSD beam: hypotheses, lengths and scores
  as the JAX searches'.

Sizes: the fixtures' (2 layers x 32, 4 heads, FF 64, V = 40; RNN 2 x 24,
embedding 16); the JAX comparisons 2 layers x 32 (RNN 2 x 24), V = 40-56.
Tolerances: 1e-4 against the recorded outputs (what tests/test_lm.py holds
the JAX LMs to); 1e-5 against the JAX modules (f32, the same arithmetic in
another order); the NLL rtol 1e-6; hypotheses and lengths exact, scores
atol 1e-4 (sums of f32 log-probabilities from two frameworks).
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emoasr_tpu.config import config_from_dict as jax_config
from emoasr_tpu.eval.decode import build_decode_fn as jax_build_decode_fn
from emoasr_tpu.eval.test_ppl import _masked_nll as jax_masked_nll
from emoasr_tpu.models.asr import ASR as JaxASR
from emoasr_tpu.models.lm.lm import LM as JaxLM
from emoasr_tpu.search.common import make_lm_fusion as jax_make_lm_fusion
from emoasr_tpu.search.ctc_beam import ctc_beam_search as jax_ctc_beam
from emoasr_tpu.search.rnnt_beam import rnnt_beam_search as jax_rnnt_beam
from emoasr_tpu.utils import torch_import as ti
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.eval.decode import build_decode_fn
from emoasr_tpu_torch.eval.test_ppl import masked_nll
from emoasr_tpu_torch.models.lm import lm as lm_mod
from emoasr_tpu_torch.models.lm.lm import LM, load_lm_state_dict, pseudo_log_likelihood
from emoasr_tpu_torch.ops import lstm_scan
from emoasr_tpu_torch.search.common import make_lm_fusion
from emoasr_tpu_torch.search.ctc_beam import ctc_beam_search
from emoasr_tpu_torch.search.rnnt_beam import rnnt_beam_search
from emoasr_tpu_torch.utils.flax_import import lm_state_dict
from test_torch_attention_beam import BASE, _batch, _same, _weights
from test_torch_conformer import port_model
from test_torch_lm_fusion import _ctc_log_probs

FIXDIR = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5
T_ = torch.from_numpy

FIX_BERT = dict(vocab_size=40, hidden_size=32, num_layers=2, num_attention_heads=4, intermediate_size=64,
                max_seq_len=24, mask_id=39)
FIX_RNN = dict(lm_type="rnn", vocab_size=40, embedding_size=16, hidden_size=24, num_layers=2, dropout_rate=0.0)
FIXTURES = {"transformer": dict(FIX_BERT, lm_type="transformer"), "bert": dict(FIX_BERT, lm_type="bert"),
            "rnn": FIX_RNN}
BERT_SMALL = dict(FIX_BERT, lm_type="bert", num_attention_heads=2, max_seq_len=16)


def random_lm_params(conf: dict, seed: int = 0) -> dict:
    """The JAX `LM` facade's params for `conf` with every leaf redrawn from
    numpy: kernels and LSTM weights ~ N(0, 1/fan_in), embeddings ~ N(0, 1),
    biases ~ N(0, 0.1^2), norm scales ~ 1 + N(0, 0.1^2)."""
    cfg = jax_config(conf)
    shapes = jax.eval_shape(lambda: JaxLM(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3), jnp.int32), jnp.array([3])))["params"]
    rng = np.random.default_rng(seed)

    def redraw(path, x):
        name, shape = path[-1].key, np.shape(x)
        if name == "kernel":
            return (rng.normal(size=shape) / math.sqrt(shape[0])).astype(np.float32)
        if name in ("weight_ih", "weight_hh"):
            return (rng.normal(size=shape) / math.sqrt(shape[1])).astype(np.float32)
        if name == "embedding":
            return rng.normal(size=shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(redraw, shapes)


def lm_pair(conf: dict, seed: int = 0):
    """(JAX `LM`, its variables, the port's `LM` on the CPU in eval mode) on
    the same weights."""
    params = random_lm_params(conf, seed)
    cfg = config_from_dict(conf)
    port = LM(cfg)
    load_lm_state_dict(port, lm_state_dict(params, cfg))
    return JaxLM(jax_config(conf)), {"params": params}, port.eval()


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=tol, rtol=0)


def _tokens(seed, B, L, V=40):
    rng = np.random.default_rng(seed)
    ys = rng.integers(3, V - 1, size=(B, L))
    ylens = np.sort(rng.integers(2, L + 1, size=B))[::-1].copy()
    ylens[0] = L
    return ys, ylens


@pytest.mark.parametrize("lm_type", ["transformer", "bert", "rnn"])
def test_lm_types_match_recorded_emoasr_outputs(lm_type):
    fx = np.load(os.path.join(FIXDIR, f"fixtures_lm_{lm_type}.npz"))
    sd = {k[4:]: T_(fx[k]) for k in fx.files if k.startswith("sd::")}
    model = LM(config_from_dict(FIXTURES[lm_type]))
    load_lm_state_dict(model, sd)
    model.eval()
    ys, ylens = T_(fx["ys"]), T_(fx["ylens"])
    with torch.no_grad():
        loss, loss_dict = model(ys, ylens, T_(fx["labels"]))
        logits = model(ys, ylens)
    np.testing.assert_allclose(loss.item(), float(fx["loss"]), rtol=1e-4)
    assert set(loss_dict) == {"loss_total"}
    if lm_type != "bert":  # the BERT fixture's logits are at its masked inputs, not these
        for b, n in enumerate(fx["ylens"] if lm_type == "transformer" else [10, 10, 10]):
            np.testing.assert_allclose(logits[b, :n].numpy(), fx["logits"][b, :n], rtol=1e-4, atol=1e-4)
    if "scores" in fx.files:
        with torch.no_grad():
            np.testing.assert_allclose(model.score(ys, ylens).numpy(), fx["scores"], rtol=1e-4)
    if lm_type == "rnn":
        with torch.no_grad():
            preds, states = model.predict(ys, ylens, model.zero_states(3))
        np.testing.assert_allclose(preds.numpy(), fx["preds"], rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(states[:, 0].numpy(), fx["h"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(states[:, 1].numpy(), fx["c"], rtol=1e-4, atol=1e-5)
        assert set(sd) == set(model.lm.state_dict())  # one multi-layer nn.LSTM's names: rnns.*_l{k}


@pytest.mark.parametrize("conf", [BERT_SMALL, dict(FIX_RNN, dropout_rate=0.2)], ids=["bert", "rnn"])
def test_lm_types_match_jax(conf):
    jm, jv, port = lm_pair(conf, seed=3)
    sd = lm_state_dict(jv["params"], port.cfg)
    assert set(sd) == set(port.lm.state_dict())
    # the JAX package's importer takes the port's names back to the same tree
    np_sd = {k: v.numpy() for k, v in sd.items()}
    back = ti.rnnlm(np_sd, 2) if conf["lm_type"] == "rnn" else ti.bert_masked_lm(np_sd, 2, "bert.")
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jv["params"]["lm"]):
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(leaf))
    ys, ylens = _tokens(4, 3, 12)
    labels = np.where(np.random.default_rng(5).random(ys.shape) < 0.4, ys, -100)
    jys, jyl = jnp.asarray(ys), jnp.asarray(ylens)
    with torch.no_grad():
        _close(port(T_(ys), T_(ylens)).numpy(), jm.apply(jv, jys, jyl))
        _close(port.score(T_(ys), T_(ylens)).numpy(), jm.apply(jv, jys, jyl, method=JaxLM.score), 1e-4)
        loss, _ = port(T_(ys), T_(ylens), T_(labels))
    jloss, _ = jm.apply(jv, jys, jyl, jnp.asarray(labels))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    if conf["lm_type"] == "rnn":
        st = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 2, 3, 24)).astype(np.float32))
        with torch.no_grad():
            lp, new = port.predict(T_(ys), T_(ylens), st)
        jlp, jnew = jm.apply(jv, jys, jyl, jnp.asarray(st.numpy()), method=JaxLM.predict)
        _close(lp.numpy(), jlp)
        _close(new.numpy(), jnew)
        # training mode with the rate at 0 computes what eval mode does
        port.lm.rnns.dropout_rate = port.lm.dropout.p = 0.0
        port.train()
        _close(port(T_(ys), T_(ylens)).detach().numpy(), jm.apply(jv, jys, jyl))


@pytest.mark.parametrize("chunk_tokens", [1, 48, 1 << 16])
def test_pseudo_log_likelihood_in_chunks_matches_jax(monkeypatch, chunk_tokens):
    """One masked copy a chunk, a few, and all at once: the head at each
    copy's masked position only, the padding positions skipped."""
    monkeypatch.setattr(lm_mod, "PLL_CHUNK_TOKENS", chunk_tokens)
    jm, jv, port = lm_pair(BERT_SMALL, seed=7)
    ys, ylens = _tokens(8, 4, 11)
    jnll, jcnt = jax_masked_nll(jm, jv["params"], jnp.asarray(ys), jnp.asarray(ylens), None, None,
                                BERT_SMALL["mask_id"])
    with torch.no_grad():
        lp = pseudo_log_likelihood(port.lm.stack, port.lm.head, T_(ys), T_(ylens), BERT_SMALL["mask_id"])
        nll, cnt = masked_nll(port, T_(ys), T_(ylens), BERT_SMALL["mask_id"])
    np.testing.assert_allclose(-lp.sum().item(), float(jnll), rtol=1e-6)
    np.testing.assert_allclose(nll.item(), float(jnll), rtol=1e-6)
    assert int(cnt) == int(jcnt) == int(ylens.sum())
    assert (lp.numpy()[np.arange(11)[None, :] >= ylens[:, None]] == 0).all()
    with torch.no_grad():
        score = port.score(T_(ys), T_(ylens))
    _close(score.numpy(), jm.apply(jv, jnp.asarray(ys), jnp.asarray(ylens), method=JaxLM.score), 1e-4)


RNN_LM = dict(lm_type="rnn", vocab_size=56, embedding_size=16, hidden_size=24, num_layers=2, dropout_rate=0.0)


@pytest.fixture(scope="module")
def rnn_lms():
    return lm_pair(RNN_LM, seed=31)


def test_rnn_lm_fusion_in_the_ctc_beam_matches_jax(rnn_lms):
    jm, jv, port = rnn_lms
    lp = _ctc_log_probs(32)
    elens = np.array([14, 11, 7], np.int32)
    ref = jax_ctc_beam(jnp.asarray(lp), jnp.asarray(elens), 4, 0, 2, 0.5, lm=jax_make_lm_fusion(jm, jv, 0.5))
    fusion = make_lm_fusion(port, 0.5)
    assert fusion.init_states(3, 4).shape == (3, 4, 2, 2, 24)
    with torch.no_grad():
        got = ctc_beam_search(T_(lp), T_(elens).long(), 4, 0, 2, 0.5, lm=fusion)
    _same(got, ref, "ctc beam + RNN LM")


@pytest.mark.parametrize("ctc_w", [0.0, 0.3])
def test_rnn_lm_fusion_in_the_attention_beam_matches_jax(rnn_lms, ctc_w):
    jm, jv, port = rnn_lms
    params, stats = _weights(-1.0, seed=33)
    conf = dict(BASE, max_decode_ylen=10, decode_len_cap="on")
    jcfg = jax_config(conf)
    jfn = jax_build_decode_fn(JaxASR(jcfg), {"params": params, "batch_stats": stats}, jcfg, 3, 0.3, ctc_w,
                              jax_make_lm_fusion(jm, jv, 0.5))
    model = port_model(conf, params, stats)
    fn = build_decode_fn(model, model.cfg, 3, 0.3, ctc_w, lm=make_lm_fusion(port, 0.5), device="cpu")
    xs, xlens = _batch(34)
    got = fn(xs, xlens)
    _same(got, jfn(jnp.asarray(xs), jnp.asarray(xlens)), f"attention beam + RNN LM, ctc {ctc_w}")
    assert int(got[1].max()) > 3


def test_rnn_lm_fusion_in_the_alsd_beam_matches_jax():
    from test_torch_rnnt import RNNT_SMALL, random_rnnt_params
    from test_torch_rnnt import V as RV
    from test_torch_rnnt import _batch as rnnt_batch

    conf = dict(RNNT_SMALL, enc_num_layers=1, mtl_ctc_weight=0.0)
    params, stats = random_rnnt_params(conf, seed=35)
    params = jax.tree_util.tree_map(np.array, params)
    params["decoder"]["output"]["bias"][3:9] += 4.0  # likely labels: some beams hold labels
    jm_lm, jv_lm, port_lm = lm_pair(dict(RNN_LM, vocab_size=RV), seed=36)
    b = rnnt_batch(7, B=3, Tn=61)
    jcfg = jax_config(conf)
    jm = JaxASR(jcfg)
    variables = {"params": params, "batch_stats": stats}
    model = port_model(conf, params, stats).eval()
    eo, el, _ = jm.apply(variables, jnp.asarray(b["xs"]), jnp.asarray(b["xlens"]), method=JaxASR.encode)

    def jrec(tok, ds):
        d, s = jm.apply(variables, tok, ds, method=lambda m, t, st: m.decoder.recurrency(t, st))
        return d[:, 0], s

    def jjoint(e, d):
        return jm.apply(variables, e, d, method=lambda m, x, y: m.decoder.joint_step(x, y))

    kw = dict(num_layers=2, dec_hidden=24, beam_width=4, vocab_size=RV, blank_id=0, eos_id=2, max_hyp_len=13)
    ref = jax_rnnt_beam(eo, el, jrec, jjoint, lm=jax_make_lm_fusion(jm_lm, jv_lm, 0.5), **kw)
    with torch.no_grad():
        e, l_, _ = model.encode(T_(b["xs"]), T_(b["xlens"]).long())

        def rec(tok, ds):
            d, s = model.decoder.recurrency(tok, ds)
            return d[:, 0], s

        got = rnnt_beam_search(e, l_, rec, model.decoder.joint_step, lm=make_lm_fusion(port_lm, 0.5), **kw)
        plain = rnnt_beam_search(e, l_, rec, model.decoder.joint_step, **kw)
    _same(got, ref, "ALSD + RNN LM")
    assert int(got[1].max()) > 1 and not torch.equal(got[0], plain[0])  # labels, and the LM changed the beams
    assert lstm_scan.KERNEL.launches == 0
