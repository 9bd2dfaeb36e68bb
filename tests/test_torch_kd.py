"""Knowledge distillation in the port against the JAX package, on the CPU.

- `create_soft_label` in both `add_eos` branches, and `ASRDataset`'s
  `soft_labels` (a missing utterance included) against the JAX dataset's.
- The five losses (`distill_loss`, `frame_to_label_mapping`,
  `ctc_align_distill_loss`, `rnnt_word_distill_loss`,
  `rnnt_align_distill_loss`): values and the gradients of the logits.
- The KD branches of the CTC decoder (alignment KD and inter-CTC KD, with
  and without `reduce_main_loss_kd`), the attention decoder and the RNN-T
  decoder (`word`, `align`): the loss dict and every parameter gradient,
  with the JAX parameters carried across by `flax_import`.
- `rnnt_forced_align` and `ASR.forced_align` (RNN-T): the alignments equal
  JAX's, on inputs whose every walk decision has a margin above 1e-3.

Sizes: 1-2 layers, widths <= 32, V <= 50.  Tolerances: the losses in
float32 within 1e-6 relative, their gradients within 1e-6 of the largest
entry (the same sums in another order); the label map and the alignments
exactly; the decoders' loss terms rtol 1e-5 and their gradients within
1e-4 of each tensor's largest entry + 1e-6, as the step tests hold them.
The JAX references run under `jax.jit`.
"""

import logging
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from emoasr_tpu.config import config_from_dict as jax_config
from emoasr_tpu.data.asr_dataset import ASRDataset as JaxASRDataset
from emoasr_tpu.data.asr_dataset import create_soft_label as jax_create_soft_label
from emoasr_tpu.models import criteria as jcrit
from emoasr_tpu.models.asr import ASR as JaxASR
from emoasr_tpu.models.decoders.ctc import CTCDecoder as JaxCTCDecoder
from emoasr_tpu.models.decoders.rnnt import RNNTDecoder as JaxRNNTDecoder
from emoasr_tpu.models.decoders.transformer import TransformerDecoder as JaxTransformerDecoder
from emoasr_tpu.ops.rnnt import rnnt_forced_align as jax_rnnt_forced_align
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.data.asr_dataset import ASRDataset, create_soft_label
from emoasr_tpu_torch.models import criteria as crit
from emoasr_tpu_torch.models.decoders.ctc import CTCDecoder
from emoasr_tpu_torch.ops import ctc_head, ctc_lattice, lstm_scan, rnnt_joint
from emoasr_tpu_torch.ops.rnnt import rnnt_align_walk, rnnt_forced_align, rnnt_fwd_bwd
from emoasr_tpu_torch.utils.flax_import import asr_state_dict
from test_torch_att_train import L3_TRAIN, l3_batch
from test_torch_conformer import port_model as l3_port_model
from test_torch_conformer import random_l3_params
from test_torch_encoder import random_flax_params
from test_torch_rnnt import RNNT_SMALL, _batch as rnnt_batch, _close_grads, random_rnnt_params
from test_torch_rnnt import port_model as rnnt_port_model

T_ = torch.from_numpy
LOSS_RTOL = 1e-6
DEC_RTOL = 1e-5
MARGIN = 1e-3


def _jit_grad(fn, *args):
    """JAX (value, gradient of the first argument) of `fn`, jitted."""
    return jax.jit(jax.value_and_grad(fn, has_aux=True))(*(jnp.asarray(a) for a in args))


def _close(got, want, rtol=LOSS_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


def _soft(rng, *shape):
    """Rows of a distribution over the last axis (what `create_soft_label`
    gives, dense)."""
    p = rng.random(shape).astype(np.float32) ** 4
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------- soft labels and the dataset


@pytest.mark.parametrize("add_eos", [False, True])
def test_create_soft_label_matches_jax(add_eos):
    kd_utt = [[(3, 0.7), (4, 0.3)], [(5, 1.0)], [(9, 0.5), (2, 0.25), (1, 0.25)], [(6, 1.0)]]
    for ylen in (2, 4, 6):  # fewer positions than labels, as many, more (zero rows)
        for lsm in (0.0, 0.1):
            got = create_soft_label(kd_utt, ylen, 10, lsm, add_eos, eos_id=2)
            want = jax_create_soft_label(kd_utt, ylen, 10, lsm, add_eos, eos_id=2)
            assert got.dtype == want.dtype == np.float32 and got.shape == (ylen + add_eos, 10)
            np.testing.assert_array_equal(got, want)


def _kd_corpus(tmp_path, n=6, V=12, F=8, T=20):
    rng = np.random.default_rng(4)
    rows, kd = [], {}
    (tmp_path / "feats").mkdir()
    for i in range(n):
        U = int(rng.integers(2, 5))
        np.save(tmp_path / "feats" / f"u{i}.npy", rng.normal(size=(T + i, F)).astype(np.float32))
        toks = rng.integers(3, V, size=U)
        utt = f"u{i}-0-{(T + i) * 10}"
        rows.append(dict(feat_path=str(tmp_path / "feats" / f"u{i}.npy"), utt_id=("sp0.9-" if i == 1 else "") + utt,
                         token_id=" ".join(map(str, toks)), text=" ".join(f"w{t}" for t in toks), xlen=T + i, ylen=U))
        if i != 3:  # u3 has no soft labels: a warning and zero rows
            kd[utt] = [[(int(t), 0.6), (int((t + 1) % V), 0.4)] for t in toks]
    tsv = tmp_path / "train.tsv"
    pd.DataFrame(rows).to_csv(tsv, sep="\t", index=False)
    pkl = tmp_path / "kd.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(kd, f)
    return str(tsv), str(pkl), V, F


@pytest.mark.parametrize("decoder", ["ctc", "transformer"])
def test_dataset_soft_labels_match_jax(tmp_path, caplog, decoder):
    tsv, pkl, V, F = _kd_corpus(tmp_path)
    conf = dict(encoder_type="transformer", decoder_type=decoder, input_layer="linear", feat_dim=F, vocab_size=V,
                kd_weight=0.5, lsm_prob=0.1, buckets=[[32, 8]], batch_size=6, max_xlens_batch=512,
                max_ylens_batch=64)
    port = ASRDataset(config_from_dict(conf), tsv, phase="train", kd_label_path=pkl)
    ref = JaxASRDataset(jax_config(conf), tsv, phase="train", kd_label_path=pkl)
    with caplog.at_level(logging.WARNING):
        got = port.collate(list(range(6)), 32, 8)
    want = ref.collate(list(range(6)), 32, 8)
    assert "soft label: u3-0-230 not found" in caplog.text
    assert got["soft_labels"].shape == (6, 8 + (decoder == "transformer"), V)
    np.testing.assert_array_equal(got["soft_labels"], want["soft_labels"])
    assert not got["soft_labels"][3, :2].any() and got["soft_labels"][1, 0].any()  # u3 zero (ylen >= 2); sp0.9 found
    # no soft labels without kd_weight, nor outside the train phase
    assert "soft_labels" not in ASRDataset(config_from_dict(dict(conf, kd_weight=0.0)), tsv,
                                           kd_label_path=pkl).collate([0], 32, 8)
    assert "soft_labels" not in ASRDataset(config_from_dict(conf), tsv, phase="test",
                                           kd_label_path=pkl).collate([0], 32, 8)


# ---------------------------------------------------------------- the five losses


@pytest.mark.parametrize("lsm_prob,normalize_length,weight", [(0.0, False, 0.5), (0.1, True, 0.3)])
def test_distill_loss_matches_jax(lsm_prob, normalize_length, weight):
    rng = np.random.default_rng(1)
    logits = (3 * rng.normal(size=(4, 7, 11))).astype(np.float32)
    ys = rng.integers(0, 11, size=(4, 7)).astype(np.int32)
    soft = _soft(rng, 4, 8, 11)  # one row more than the logits: the loss reads the first L
    ylens = np.array([7, 4, 1, 0], np.int32)
    kw = dict(soft_label_weight=weight, lsm_prob=lsm_prob, normalize_length=normalize_length)
    (jl, (js, jh)), jg = _jit_grad(
        lambda x, y, s, yl: (lambda r: (r[0], r[1:]))(jcrit.distill_loss(x, y, s, yl, **kw)), logits, ys, soft, ylens)
    x = T_(logits).requires_grad_()
    loss, ls, lh = crit.distill_loss(x, T_(ys), T_(soft), T_(ylens), **kw)
    (g,) = torch.autograd.grad(loss, x)
    for a, b in ((loss, jl), (ls, js), (lh, jh)):
        np.testing.assert_allclose(a.item(), float(b), rtol=LOSS_RTOL)
    _close(g.numpy(), jg)


def _aligns(rng, ys, ylens, xlens, T, blank=0):
    """CTC-style frame alignments of `ys`: per label some blanks, then the
    label repeated; repeated labels without a blank between merge."""
    B = len(ys)
    out = np.zeros((B, T), np.int32)
    for b in range(B):
        t = 0
        for u in range(ylens[b]):
            t += int(rng.integers(0, 2))
            for _ in range(int(rng.integers(1, 3))):
                if t < xlens[b]:
                    out[b, t] = ys[b, u]
                t += 1
        out[b, xlens[b]:] = rng.integers(0, 9, size=T - xlens[b])  # past xlens: ignored
    return out


def _ctc_case(seed=2, B=4, T=16, U=5, V=9):
    rng = np.random.default_rng(seed)
    ylens = np.array([5, 3, 1, 0][:B], np.int32)
    xlens = np.array([16, 11, 5, 3][:B], np.int32)
    ys = rng.integers(1, V, size=(B, U)).astype(np.int32)
    ys[0, 2] = ys[0, 1]  # a repeated label
    aligns = _aligns(rng, ys, ylens, xlens, T)
    logits = (2 * rng.normal(size=(B, T, V))).astype(np.float32)
    return logits, ys, _soft(rng, B, U, V), aligns, xlens, ylens


@pytest.mark.parametrize("position", ["all", "left", "mid", "right"])
def test_frame_to_label_mapping_matches_jax(position):
    _, ys, _, aligns, xlens, ylens = _ctc_case()
    want = jax.jit(lambda a, x, y: jcrit.frame_to_label_mapping(a, x, y, 0, position))(aligns, xlens, ylens)
    got = crit.frame_to_label_mapping(T_(aligns), T_(xlens), T_(ylens), 0, position)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() >= 0).any()
    # the config's documented spelling "middle" is refused on both sides
    with pytest.raises(ValueError):
        jcrit.frame_to_label_mapping(jnp.asarray(aligns), jnp.asarray(xlens), jnp.asarray(ylens), 0, "middle")
    with pytest.raises(ValueError):
        crit.frame_to_label_mapping(T_(aligns), T_(xlens), T_(ylens), 0, "middle")


@pytest.mark.parametrize("normalize_length", [True, False])
@pytest.mark.parametrize("weight", [1.0, 0.5, 0.0])
def test_ctc_align_distill_loss_matches_jax(weight, normalize_length):
    logits, ys, soft, aligns, xlens, ylens = _ctc_case()
    kw = dict(blank_id=0, soft_label_weight=weight, position="mid" if weight == 0.5 else "all", lsm_prob=0.1,
              normalize_length=normalize_length)
    (jl, _), jg = _jit_grad(lambda x, *r: (jcrit.ctc_align_distill_loss(x, *r, **kw), 0.0),
                            logits, ys, soft, aligns, xlens, ylens)
    x = T_(logits).requires_grad_()
    loss = crit.ctc_align_distill_loss(x, *(T_(a) for a in (ys, soft, aligns, xlens, ylens)), **kw)
    (g,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    assert loss.item() != 0.0
    _close(g.numpy(), jg)


def _rnnt_case(seed=3, B=3, T=9, U=4, V=10):
    rng = np.random.default_rng(seed)
    logits = (2 * rng.normal(size=(B, T, U + 1, V))).astype(np.float32)
    xlens, ylens = np.array([9, 6, 2][:B], np.int32), np.array([4, 2, 0][:B], np.int32)
    return rng, logits, _soft(rng, B, U + 1, V), xlens, ylens


def test_rnnt_word_distill_loss_matches_jax():
    """The JAX function wants U + 1 soft rows; the port also takes the U
    rows a transducer's dataset gives (row U is never read), and the
    log-softmax of the logits where its caller has it (the decoder)."""
    _, logits, soft, xlens, ylens = _rnnt_case()
    (jl, _), jg = _jit_grad(lambda x, *r: (jcrit.rnnt_word_distill_loss(x, *r), 0.0), logits, soft, xlens, ylens)
    for rows, given in ((soft, False), (soft[:, :-1], False), (soft, True)):
        x = T_(logits).requires_grad_()
        lp = torch.log_softmax(x, dim=-1) if given else None
        loss = crit.rnnt_word_distill_loss(x, T_(rows.copy()), T_(xlens), T_(ylens), log_probs=lp)
        (g,) = torch.autograd.grad(loss, x)
        np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
        _close(g.numpy(), jg)


def test_rnnt_align_distill_loss_matches_jax():
    rng, logits, soft, xlens, ylens = _rnnt_case()
    aligns = rng.integers(-2, 12, size=(3, 4)).astype(np.int32)  # out of range: clipped to [0, T)
    (jl, _), jg = _jit_grad(lambda x, *r: (jcrit.rnnt_align_distill_loss(x, *r), 0.0),
                            logits, soft[:, :-1], aligns, xlens, ylens)
    x = T_(logits).requires_grad_()
    loss = crit.rnnt_align_distill_loss(x, T_(soft[:, :-1].copy()), T_(aligns), T_(xlens), T_(ylens))
    (g,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    _close(g.numpy(), jg)


# ---------------------------------------------------------------- the decoders' KD branches

CTC_KD = dict(encoder_type="transformer", decoder_type="ctc", input_layer="conv2d", feat_dim=20, enc_hidden_size=32,
              enc_num_attention_heads=4, enc_num_layers=2, enc_intermediate_size=64, vocab_size=37,
              mtl_inter_ctc_weight=0.3, inter_ctc_layer_id=1, kd_weight=0.4, inter_kd_weight=0.6, lsm_prob=0.1,
              dropout_enc_rate=0.0, dropout_attn_rate=0.0)


def _decoder_grads(dec, loss, e, prefix="decoder."):
    names = [prefix + n for n, _ in dec.named_parameters()]
    grads = torch.autograd.grad(loss, [e] + list(dec.parameters()))
    return grads[0], dict(zip(names, grads[1:]))


@pytest.mark.parametrize("reduce_main,position,soft_weight", [(False, "all", 1.0), (True, "mid", 0.7)])
def test_ctc_decoder_kd_matches_jax(reduce_main, position, soft_weight):
    """Alignment KD of the main head and inter-CTC KD of the intermediate
    layer's output, both `reduce_main_loss_kd` branches."""
    conf = dict(CTC_KD, reduce_main_loss_kd=reduce_main, kd_ctc_position=position,
                kd_ctc_soft_label_weight=soft_weight)
    params = random_flax_params(conf, seed=3)
    rng = np.random.default_rng(6)
    B, T, U, V = 3, 14, 4, 37
    eouts, inter = (rng.normal(size=(2, B, T, 32))).astype(np.float32)
    elens, ylens = np.array([14, 9, 6], np.int32), np.array([4, 2, 1], np.int32)
    ys = rng.integers(1, V, size=(B, U)).astype(np.int32)
    soft = _soft(rng, B, U, V)

    def jloss(p, e, ei):
        loss, d, logits = JaxCTCDecoder(jax_config(conf)).apply({"params": p}, e, jnp.asarray(elens), ei,
                                                                jnp.asarray(ys), jnp.asarray(ylens),
                                                                soft_labels=jnp.asarray(soft))
        return loss, (d, logits)

    (jl, (jdict, jlogits)), (jg, jge, jgi) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        params["decoder"], jnp.asarray(eouts), jnp.asarray(inter))
    dec = CTCDecoder(config_from_dict(conf))
    sd = asr_state_dict(params, config_from_dict(conf))
    dec.load_state_dict({k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")})
    e, ei = T_(eouts).requires_grad_(), T_(inter).requires_grad_()
    loss, loss_dict, logits = dec(e, T_(elens), ei, T_(ys), T_(ylens), soft_labels=T_(soft))
    assert set(loss_dict) == set(jdict) == {"loss_ctc", "loss_kd", "loss_inter_ctc", "loss_inter_kd", "loss_total"}
    for k in jdict:
        np.testing.assert_allclose(loss_dict[k].item(), float(jdict[k]), rtol=DEC_RTOL, err_msg=k)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=0, atol=1e-5)
    grads = torch.autograd.grad(loss, [e, ei] + list(dec.parameters()))
    for g, jgr in zip(grads[:2], (jge, jgi)):
        _close(g.numpy(), jgr, 1e-4)
    ref = asr_state_dict({"encoder": params["encoder"], "decoder": jax.tree_util.tree_map(np.asarray, jg)},
                         config_from_dict(conf))
    _close_grads(dict(zip([f"decoder.{n}" for n, _ in dec.named_parameters()], grads[2:])),
                 {k: v for k, v in ref.items() if k.startswith("decoder.")})
    assert ctc_head.KERNEL.launches == ctc_lattice.KERNEL.launches == 0


def test_attention_decoder_kd_matches_jax():
    """`distill_loss` over ylens + 1 at `soft_label_weight = kd_weight`; the
    auxiliary CTC takes no soft labels."""
    conf = dict(L3_TRAIN, kd_weight=0.5)
    params, stats = random_l3_params(conf, seed=21)
    b = l3_batch(1)
    rng = np.random.default_rng(5)
    eouts, elens = rng.normal(size=(3, 10, 32)).astype(np.float32), np.array([10, 7, 4], np.int32)
    soft = _soft(rng, 3, 6, 50)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def jloss(p, e):
        loss, d, _ = JaxTransformerDecoder(jax_config(conf)).apply(
            {"params": p}, e, jnp.asarray(elens), None, jb["ys"], jb["ylens"], jb["ys_in"], jb["ys_out"],
            jnp.asarray(soft))
        return loss, d

    (jl, jdict), (jg, jge) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params["decoder"], jnp.asarray(eouts))
    dec = l3_port_model(conf, params, stats).decoder
    e = T_(eouts).requires_grad_()
    t = {k: T_(v) for k, v in b.items()}
    loss, loss_dict, _ = dec(e, T_(elens), None, t["ys"], t["ylens"], t["ys_in"], t["ys_out"], T_(soft))
    assert set(loss_dict) == set(jdict) == {"loss_kd", "loss_att", "loss_ctc", "loss_total"}
    for k in jdict:
        np.testing.assert_allclose(loss_dict[k].item(), float(jdict[k]), rtol=DEC_RTOL, err_msg=k)
    ge, grads = _decoder_grads(dec, loss, e)
    _close(ge.numpy(), jge, 1e-4)
    ref = asr_state_dict({"encoder": params["encoder"], "decoder": jax.tree_util.tree_map(np.asarray, jg)},
                         config_from_dict(conf), stats)
    _close_grads(grads, {k: v for k, v in ref.items() if k.startswith("decoder.")})


@pytest.fixture(scope="module")
def rnnt_weights():
    return random_rnnt_params(dict(RNNT_SMALL, mtl_ctc_weight=0.3), seed=1)


@pytest.mark.parametrize("kd_type,reduce_main", [("word", False), ("align", True)])
def test_rnnt_decoder_kd_matches_jax(rnnt_weights, kd_type, reduce_main):
    """KD switches the joint to `full` (the yaml says `pallas`: K7 stays
    off); the port reads the dataset's U soft rows, the JAX decoder U + 1
    (its word loss needs them)."""
    params, stats = rnnt_weights
    conf = dict(RNNT_SMALL, mtl_ctc_weight=0.3, kd_weight=0.3, kd_type=kd_type, reduce_main_loss_kd=reduce_main)
    b = rnnt_batch(2)
    rng = np.random.default_rng(3)
    eouts, elens = rng.normal(size=(3, 17, 32)).astype(np.float32), np.array([17, 11, 1], np.int32)
    soft = _soft(rng, 3, 6, 29)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def jloss(p, e):
        loss, d, _ = JaxRNNTDecoder(jax_config(conf)).apply(
            {"params": p}, e, jnp.asarray(elens), None, jb["ys"], jb["ylens"], jb["ys_in"], jb["ys_out"],
            jnp.asarray(soft))
        return loss, d

    (jl, jdict), (jg, jge) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params["decoder"], jnp.asarray(eouts))
    dec = rnnt_port_model(conf, params, stats).decoder
    e = T_(eouts).requires_grad_()
    t = {k: T_(v) for k, v in b.items()}
    loss, loss_dict, logits = dec(e, T_(elens), None, t["ys"], t["ylens"], t["ys_in"], t["ys_out"],
                                  T_(soft[:, :-1].copy()))
    assert logits.shape == (3, 17, 6, 29)
    assert set(loss_dict) == set(jdict) == {"loss_rnnt", "loss_ctc", "loss_kd", "loss_total"}
    for k in jdict:
        np.testing.assert_allclose(loss_dict[k].item(), float(jdict[k]), rtol=DEC_RTOL, err_msg=k)
    ge, grads = _decoder_grads(dec, loss, e)
    _close(ge.numpy(), jge, 1e-4)
    ref = asr_state_dict({"encoder": params["encoder"], "decoder": jax.tree_util.tree_map(np.asarray, jg)},
                         config_from_dict(conf), stats)
    _close_grads(grads, {k: v for k, v in ref.items() if k.startswith("decoder.")})
    assert rnnt_joint.KERNEL.launches == lstm_scan.KERNEL.launches == 0


# ---------------------------------------------------------------- RNN-T forced alignment


def _assert_decisive(fwd_bwd, xlens, ylens):
    """Every decision of the walk over these inputs has a margin
    |fwd_bwd[t + 1, u] - fwd_bwd[t, u + 1]| above MARGIN, so a difference in
    the alignments is a fault, not a tie; the walk retraced on the host
    (the rule of `rnnt_align_walk`) lands where the device's does."""
    fb = fwd_bwd.numpy()
    aligns, margins = np.zeros((fb.shape[0], fb.shape[2] - 1), np.int32), []
    for b in range(fb.shape[0]):
        t = u = 0
        while t + 1 < int(xlens[b]) and u < int(ylens[b]):
            go_t, go_u = fb[b, t + 1, u], fb[b, t, u + 1]
            margins.append(abs(go_t - go_u))
            if go_t > go_u:
                t += 1
            else:
                aligns[b, u], u = t, u + 1
    np.testing.assert_array_equal(rnnt_align_walk(fwd_bwd, xlens, ylens).numpy(), aligns)
    assert len(margins) > 10 and min(margins) > MARGIN, min(margins)


@pytest.mark.parametrize("seed", [0, 5])
def test_rnnt_forced_align_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, T, U1, V = 3, 11, 5, 7
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray((2 * rng.normal(size=(B, T, U1, V))).astype(np.float32)), -1))
    labels = rng.integers(1, V, size=(B, U1 - 1)).astype(np.int32)
    xlens, ylens = np.array([11, 8, 5], np.int32), np.array([4, 2, 3], np.int32)
    want = jax.jit(jax_rnnt_forced_align)(lp, xlens, labels, ylens)
    got = rnnt_forced_align(T_(lp), T_(xlens), T_(labels), T_(ylens))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fb = rnnt_fwd_bwd(T_(lp), T_(xlens), T_(labels), T_(ylens))
    _assert_decisive(fb, T_(xlens), T_(ylens))
    # alpha + beta at (0, 0) is the utterance's log-likelihood
    from emoasr_tpu_torch.ops.rnnt import rnnt_loss
    nll = rnnt_loss(T_(lp), T_(labels), T_(xlens), T_(ylens), reduction="none")
    np.testing.assert_allclose(fb[:, 0, 0].numpy(), -nll.numpy(), rtol=1e-5)


def test_asr_forced_align_rnnt_matches_jax(rnnt_weights):
    """`ASR.forced_align`: the eos-led `ys_in` made from `ys`, the
    recurrency (K8's plain version), the joint, the walk."""
    params, stats = rnnt_weights
    conf = dict(RNNT_SMALL, mtl_ctc_weight=0.3)
    b = rnnt_batch(7, B=3, Tn=61)
    variables = {"params": params, "batch_stats": stats}
    jm = JaxASR(jax_config(conf))
    want = jax.jit(lambda *a: jm.apply(variables, *a, method=JaxASR.forced_align))(
        *(jnp.asarray(b[k]) for k in ("xs", "xlens", "ys", "ylens")))
    model = rnnt_port_model(conf, params, stats).eval()
    t = {k: T_(v) for k, v in b.items()}
    got = model.forced_align(t["xs"], t["xlens"], t["ys"], t["ylens"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), model.forced_align(t["xs"], t["xlens"], t["ys"], t["ylens"],
                                                                  t["ys_in"]).numpy())
    with torch.no_grad():
        eouts, elens, _ = model.encode(t["xs"], t["xlens"])
        lp = torch.log_softmax(model.decoder.joint(eouts, model.decoder.recurrency(t["ys_in"])[0]), -1)
    _assert_decisive(rnnt_fwd_bwd(lp, elens, t["ys"], t["ylens"]), elens, t["ylens"])
    assert lstm_scan.KERNEL.launches == 0
