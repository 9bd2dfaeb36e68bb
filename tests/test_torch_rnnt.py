"""The port's RNN-T decoder and searches against the JAX package's, on the
CPU (the train step of the whole model: `test_torch_rnnt_train.py`).

- `RNNTDecoder` on given encoder outputs: the loss terms and the gradients
  to every decoder parameter and to the encoder outputs, in the three
  joint modes (`full`, `chunked`, `pallas`; the port's fused joint on its
  plain version, the JAX kernel in interpret mode), without and with the
  auxiliary CTC loss; a single-frame utterance and one without labels in
  the batch.
- Greedy decoding of a tiny RNN-T(Conformer) model: hyps, lengths and
  alignments exact.
- The ALSD beam at widths 1 and 4: hyps and lengths exact, scores within
  1e-4 (logsumexp merges in two frameworks).
- What is not ported yet raises and names its slice (LM fusion in the ALSD
  beam is ported: tests/test_torch_lm_types.py).

Sizes: 2 Conformer layers, d=32, 4 heads; embedding 16, LSTM 2 x 24 (the
scan: below 8 steps, and on the CPU), joint 20, V=29.  Tolerances: loss
rtol 1e-5; gradients 1e-4 of each tensor's largest entry + 1e-6 (float32
sums in two frameworks' orders).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emoasr_tpu.config import config_from_dict as jax_config
from emoasr_tpu.models.asr import ASR as JaxASR
from emoasr_tpu.models.decoders.rnnt import RNNTDecoder as JaxRNNTDecoder
from emoasr_tpu.search.rnnt_beam import rnnt_beam_search as jax_rnnt_beam
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.models.asr import ASR
from emoasr_tpu_torch.models.decoders.rnnt import RNNTDecoder
from emoasr_tpu_torch.ops import ctc_head, ctc_lattice, lstm_scan, rnnt_joint, topk
from emoasr_tpu_torch.search.rnnt_beam import rnnt_beam_search
from emoasr_tpu_torch.utils.flax_import import asr_state_dict

T_ = torch.from_numpy
V = 29

RNNT_SMALL = dict(
    encoder_type="conformer", decoder_type="rnn_transducer", pos_encode_type="rel",
    input_layer="conv2d", feat_dim=20, enc_hidden_size=32, enc_num_attention_heads=4,
    enc_num_layers=2, enc_intermediate_size=64, conv_kernel_size=7,
    embedding_size=16, dec_hidden_size=24, dec_num_layers=2, joint_hidden_size=20,
    vocab_size=V, blank_id=0, eos_id=2, max_decode_ylen=12, rnnt_joint_mode="pallas",
    dropout_enc_rate=0.0, dropout_attn_rate=0.0, dropout_dec_rate=0.0, dropout_emb_rate=0.0,
    spec_augment=False, lr_schedule_type="noam", learning_rate=2.0, num_warmup_steps=4,
    clip_grad_norm=5.0, weight_decay=1e-3, accum_grad=2,
)


def random_rnnt_params(conf: dict, seed: int = 0):
    """JAX ASR (params, batch_stats) for an RNN-T model, every leaf redrawn
    from numpy: kernels ~ N(0, 1/fan_in), embeddings ~ N(0, 1), LSTM
    weights, biases and pos_bias_u/v ~ N(0, 0.1^2), norm scales ~ 1 +
    N(0, 0.1^2), BatchNorm var ~ 1 + |N(0, 0.2^2)|."""
    cfg = jax_config(conf)
    xs, xl = jnp.zeros((1, 32, cfg.feat_dim)), jnp.array([32])
    ys, ys_in = jnp.ones((1, 2), jnp.int32), jnp.ones((1, 3), jnp.int32)
    var = jax.eval_shape(  # the loss route, so that the aux CTC head is initialised too
        lambda: JaxASR(cfg).init(jax.random.PRNGKey(0), xs, xl, ys, jnp.array([2]), ys_in, ys_in)
    )
    rng = np.random.default_rng(seed)

    def redraw(path, x):
        name, shape = path[-1].key, np.shape(x)
        if name == "kernel":
            return (rng.normal(size=shape) / math.sqrt(int(np.prod(shape[:-1])))).astype(np.float32)
        if name == "embedding":
            return rng.normal(size=shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "var":
            return (1.0 + np.abs(0.2 * rng.normal(size=shape))).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(redraw, var["params"])
    stats = jax.tree_util.tree_map_with_path(redraw, var.get("batch_stats", {}))
    return params, stats


def port_model(conf: dict, params, stats) -> ASR:
    cfg = config_from_dict(conf)
    model = ASR(cfg)
    model.load_state_dict(asr_state_dict(params, cfg, stats))
    return model


def _batch(seed=0, B=3, Tn=41, U=5):
    rng = np.random.default_rng(seed)
    ylens = np.array([U, 3, 0][:B], np.int32)
    ys = rng.integers(3, V, size=(B, U)).astype(np.int32)
    ys = np.where(np.arange(U)[None, :] < ylens[:, None], ys, 2).astype(np.int32)  # eos padding
    ys_in = np.concatenate([np.full((B, 1), 2, np.int32), ys], axis=1)  # eos-led, no eos appended
    return dict(xs=rng.normal(size=(B, Tn, 20)).astype(np.float32), xlens=np.array([41, 30, 17][:B], np.int32),
                ys=ys, ylens=ylens, ys_in=ys_in, ys_out=np.full((B, U + 1), 2, np.int32))


def _close_grads(got: dict, ref: dict, tol=1e-4):
    assert set(got) == set(ref)
    for name, g in got.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=tol * np.abs(r).max() + 1e-6, err_msg=name)


@pytest.fixture(scope="module")
def weights():
    return random_rnnt_params(dict(RNNT_SMALL, mtl_ctc_weight=0.3), seed=1)


@pytest.mark.parametrize("mtl", [False, True])
@pytest.mark.parametrize("mode", ["full", "chunked", "pallas"])
def test_decoder_loss_and_gradients_match_jax(weights, mode, mtl):
    """`RNNTDecoder` alone on given encoder outputs: the loss terms and the
    gradients to every decoder parameter and to the encoder outputs."""
    params, _ = weights
    conf = dict(RNNT_SMALL, rnnt_joint_mode=mode, mtl_ctc_weight=0.3 if mtl else 0.0)
    dec = {k: v for k, v in params["decoder"].items() if mtl or k != "ctc"}
    b = _batch(2)
    rng = np.random.default_rng(3)
    eouts = rng.normal(size=(3, 17, 32)).astype(np.float32)
    elens = np.array([17, 11, 1], np.int32)  # a single-frame utterance
    jcfg = jax_config(conf)

    def jloss(p, e):
        return JaxRNNTDecoder(jcfg).apply(
            {"params": p}, e, jnp.asarray(elens), None, *(jnp.asarray(b[k]) for k in ("ys", "ylens", "ys_in", "ys_out")),
            deterministic=True)[:2]

    (jl, jdict), (jg, jge) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(dec, jnp.asarray(eouts))
    cfg = config_from_dict(conf)
    model = RNNTDecoder(cfg)
    sd = asr_state_dict({"encoder": params["encoder"], "decoder": dec}, cfg)
    model.load_state_dict({k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")})
    e = T_(eouts.copy()).requires_grad_(True)
    t = {k: T_(v) for k, v in b.items()}
    loss, loss_dict, logits = model(e, T_(elens), None, t["ys"], t["ylens"], t["ys_in"], t["ys_out"])
    assert (logits is not None) == (mode == "full")
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()) + [e])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert set(loss_dict) == set(jdict)
    for k in jdict:
        np.testing.assert_allclose(loss_dict[k].item(), float(jdict[k]), rtol=1e-5, err_msg=k)
    ref = asr_state_dict({"encoder": params["encoder"], "decoder": jax.tree_util.tree_map(np.asarray, jg)}, cfg)
    _close_grads(dict(zip(names, grads[:-1])), {k[len("decoder."):]: v for k, v in ref.items()
                                                 if k.startswith("decoder.")})
    _close_grads({"eouts": grads[-1]}, {"eouts": T_(np.asarray(jge))})
    for k in (rnnt_joint.KERNEL, lstm_scan.KERNEL, ctc_head.KERNEL, ctc_lattice.KERNEL):
        assert k.launches == 0


def _encode_both(conf, params, stats):
    jcfg = jax_config(conf)
    jm = JaxASR(jcfg)
    variables = {"params": params, "batch_stats": stats}
    model = port_model(conf, params, stats).eval()
    return jcfg, jm, variables, model


def test_greedy_matches_jax(weights):
    params, stats = weights
    conf = dict(RNNT_SMALL, mtl_ctc_weight=0.3, max_decode_ylen=7)
    params = jax.tree_util.tree_map(np.copy, params)
    params["decoder"]["output"]["bias"][0] += 0.5  # blank wins often enough: rows end by length and by the cap
    b = _batch(5, B=3, Tn=61)
    jcfg, jm, variables, model = _encode_both(conf, params, stats)
    jh, jl, _, ja = jm.apply(variables, jnp.asarray(b["xs"]), jnp.asarray(b["xlens"]), method=JaxASR.decode_greedy)
    h, hl, logits, a = model.decode_greedy(T_(b["xs"]), T_(b["xlens"]).long())
    assert logits is None
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(hl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert 0 < hl.min() and hl.max() == 7  # some labels, and the cap reached


@pytest.mark.parametrize("beam", [1, 4])
def test_alsd_beam_matches_jax(weights, beam):
    params, stats = weights
    conf = dict(RNNT_SMALL, mtl_ctc_weight=0.3)
    b = _batch(6, B=3, Tn=61)
    jcfg, jm, variables, model = _encode_both(conf, params, stats)
    eo, el, _ = jm.apply(variables, jnp.asarray(b["xs"]), jnp.asarray(b["xlens"]), method=JaxASR.encode)

    def jrec(tok, ds):
        d, s = jm.apply(variables, tok, ds, method=lambda m, t, st: m.decoder.recurrency(t, st))
        return d[:, 0], s

    def jjoint(e, d):
        return jm.apply(variables, e, d, method=lambda m, x, y: m.decoder.joint_step(x, y))

    kw = dict(num_layers=2, dec_hidden=24, beam_width=beam, vocab_size=V, blank_id=0, eos_id=2, max_hyp_len=13)
    jh, jl, js = jax_rnnt_beam(eo, el, jrec, jjoint, **kw)
    with torch.no_grad():
        e, l_, _ = model.encode(T_(b["xs"]), T_(b["xlens"]).long())

        def rec(tok, ds):
            d, s = model.decoder.recurrency(tok, ds)
            return d[:, 0], s

        h, hl, s = rnnt_beam_search(e, l_, rec, model.decoder.joint_step, **kw)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(hl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-4)
    if beam > 1:
        assert hl.max() > 1  # labels were emitted
    assert topk.KERNEL.launches == 0


def test_unported_branches_raise_and_name_their_slice(weights):
    params, stats = weights
    """Slice 7b ported the distillation branch and the forced alignment:
    they run now (their parity is in test_torch_kd.py); an unknown joint
    mode is still refused."""
    model = port_model(dict(RNNT_SMALL, mtl_ctc_weight=0.3, kd_weight=0.5), params, stats)
    b = {k: T_(v) for k, v in _batch(0).items()}
    soft = torch.full((3, 5, V), 1.0 / V)
    loss, loss_dict = model(b["xs"], b["xlens"], b["ys"], b["ylens"], b["ys_in"], b["ys_out"], soft_labels=soft)
    assert set(loss_dict) == {"loss_rnnt", "loss_ctc", "loss_kd", "loss_total"} and torch.isfinite(loss)
    aligns = model.forced_align(b["xs"], b["xlens"], b["ys"], b["ylens"])
    assert aligns.shape == (3, 5) and aligns.dtype == torch.int32
    assert (aligns[2] == 0).all() and (aligns[1, 3:] == 0).all()  # past ylens (5, 3, 0): 0
    assert (aligns[0, 1:] >= aligns[0, :-1]).all() and (aligns[1, 1:3] >= aligns[1, :2]).all()  # frames ascend
    with pytest.raises(ValueError, match="rnnt_joint_mode"):
        ASR(config_from_dict(dict(RNNT_SMALL, rnnt_joint_mode="fast")))
