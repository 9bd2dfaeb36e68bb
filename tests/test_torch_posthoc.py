"""The port's post-hoc tools against the JAX package, on the CPU: N-best
rescoring (`eval/rescore.py`), error correction (`eval/correct.py`) and the
eval CLI's `--decode_phone`.

- `score_lm` per hypothesis for the Transformer, BERT and ELECTRA LMs
  (whatever the batch and padding) and `grid_search`'s choice, against the
  JAX `score_lm` / `grid_search` on the same weights.
- The rescoring CLI's two TSVs (the cached scores, the best hypotheses)
  against the JAX CLI's, the JAX CLI reading the port's ELECTRA
  checkpoint.
- `aggregate_logits` (host) and `aggregate_logits_device` against JAX, at
  blank gaps between equal tokens, a fully blank row and K < T'.
- `correct.test_main` on both packages over one tiny corpus (the shape of
  tests/test_correct_cli.py::_setup, copied), an ASR model with a
  hierarchical phone CTC head: BERT fill, `pbert` fill from the phone
  hypotheses, and the `pctc` cascade; the corrected TSVs row for row.
- `test_asr --decode_phone` (greedy and the prefix beam) against the JAX
  CLI: the phone TSVs and their PER line.

Sizes: 1-2 layers x 16-32, V = 12-40, 9 phones.  Tolerances: `score_lm`
rtol 1e-5 (atol 1e-5 near 0); aggregated probabilities and confidences
rtol 1e-5; TSVs and hypotheses exact.
"""

import argparse
import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from emoasr_tpu.config import config_from_dict as jax_config
from emoasr_tpu.eval import correct as jax_correct
from emoasr_tpu.eval import rescore as jax_rescore
from emoasr_tpu.eval import test_asr as jax_test_asr
from emoasr_tpu.models.asr import ASR as JaxASR
from emoasr_tpu.models.lm.lm import LM as JaxLM
from emoasr_tpu.train import checkpoint as jax_ckpt
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.eval import correct, rescore, test_asr
from emoasr_tpu_torch.train.checkpoint import save_state_dict
from emoasr_tpu_torch.utils.flax_import import asr_state_dict, lm_state_dict
from test_torch_lm_p2w import ELECTRA, P2W, jax_lm_params, redraw_params
from test_torch_lm_p2w import lm_pair as p2w_lm_pair
from test_torch_lm_types import BERT_SMALL
from test_torch_lm_types import lm_pair as bert_lm_pair

T_ = torch.from_numpy
LMS = {"transformer": dict(BERT_SMALL, lm_type="transformer", max_seq_len=24), "bert": dict(BERT_SMALL,
                                                                                              max_seq_len=24),
       "electra": ELECTRA}


def _nbest(seed, n_utts=6, W=4, V=38):
    """An n-best TSV's rows (the eval CLI's `--nbest` columns) and the
    references."""
    rng = np.random.default_rng(seed)
    rows, refs = [], []
    for u in range(n_utts):
        utt = f"spk-u{u}-{100 * u}-{100 * u + 250}"
        ref = rng.integers(3, V, size=int(rng.integers(2, 9)))
        refs.append(dict(utt_id=utt, text=" ".join(f"w{t}" for t in ref)))
        for _ in range(W):
            h = ref.copy()
            if rng.random() < 0.7:  # a substitution, an insertion or a deletion
                k = int(rng.integers(0, len(h)))
                h = [np.delete(h, k), np.insert(h, k, rng.integers(3, V)), np.where(np.arange(len(h)) == k,
                                                                                  rng.integers(3, V), h)][
                    int(rng.integers(0, 3))]
            rows.append(dict(utt_id=utt, score_asr=float(rng.normal() * 3), token_id=" ".join(map(str, h)),
                             text=" ".join(f"w{t}" for t in h), reftext=refs[-1]["text"]))
    return pd.DataFrame(rows), pd.DataFrame(refs)


def _lm(lm_type, seed):
    if lm_type == "electra":
        return p2w_lm_pair(ELECTRA, seed)
    return bert_lm_pair(LMS[lm_type], seed)


@pytest.mark.parametrize("lm_type", ["transformer", "bert", "electra"])
def test_score_lm_and_grid_match_jax(lm_type):
    jm, jv, port = _lm(lm_type, seed=40)
    df, dfref = _nbest(41)
    want = jax_rescore.score_lm(df, jm, jv, max_len=24)
    for batch_size in (5, 128):  # rows beside a hypothesis and padding do not change its score
        got = rescore.score_lm(df, port, max_len=24, batch_size=batch_size)
        np.testing.assert_allclose(got["score_lm"].to_numpy(), want["score_lm"].to_numpy(), rtol=1e-5, atol=1e-5)
    lm_range, len_range = np.arange(0, 1.0001, 0.25), np.arange(0, 2.0001, 1)
    best = rescore.grid_search(got, dfref, lm_range, len_range)
    jbest = jax_rescore.grid_search(want, dfref, lm_range, len_range)
    assert best[:3] == jbest[:3]
    pd.testing.assert_frame_equal(best[3].reset_index(drop=True), jbest[3].reset_index(drop=True))
    wer, _, picked = rescore.rescore(got, dfref, 1.0, 0.0)
    jwer, _, jpicked = jax_rescore.rescore(want, dfref, 1.0, 0.0)
    assert wer == jwer and picked["token_id"].tolist() == jpicked["token_id"].tolist()


def test_rescore_cli_matches_the_jax_cli_on_a_port_checkpoint(tmp_path):
    """The port's ELECTRA checkpoint (`lm.`-prefixed `state_dict`), rescored
    by both CLIs: the cached `*_electra.tsv` and the best `*_lm{w}_len{w}.tsv`
    equal; the runtime mode returns one RTF a repeat."""
    params = jax_lm_params(ELECTRA, seed=42)
    cfg = config_from_dict(ELECTRA)
    lm_conf = tmp_path / "electra.yaml"
    lm_conf.write_text(yaml.safe_dump(ELECTRA))
    save_state_dict({f"lm.{k}": v for k, v in lm_state_dict(params, cfg).items()},
                    str(tmp_path / "electra" / "checkpoints" / "model.ep3"))
    df, dfref = _nbest(43)
    ref = tmp_path / "ref.tsv"
    dfref.to_csv(ref, sep="\t", index=False)
    outs = {}
    for side in ("torch", "jax"):
        d = tmp_path / side
        d.mkdir()
        df.to_csv(d / "result_nbest.tsv", sep="\t", index=False)
        argv = [str(d / "result_nbest.tsv"), "-ref", str(ref), "-lm_conf", str(lm_conf), "-lm_ep", "3",
                "--lm_step", "0.5", "--len_max", "2"]
        if side == "torch":
            got = rescore.main(argv + ["--cpu"])
        else:
            got = jax_rescore.main(jax_rescore.build_argparser().parse_args(argv))
        outs[side] = (got, sorted(os.listdir(d)))
    assert outs["torch"] == outs["jax"]
    for name in outs["torch"][1]:
        a, b = pd.read_table(tmp_path / "torch" / name), pd.read_table(tmp_path / "jax" / name)
        if "score_lm" in a:
            np.testing.assert_allclose(a.pop("score_lm"), b.pop("score_lm"), rtol=1e-5)
        pd.testing.assert_frame_equal(a, b)
    runtimes, rtfs = rescore.main([str(tmp_path / "torch" / "result_nbest.tsv"), "-ref", str(ref), "-lm_conf",
                                   str(lm_conf), "-lm_ep", "3", "--runtime", "--runtime_num_repeats", "2",
                                   "--runtime_num_samples", "3", "--cpu"])
    assert len(rtfs) == 2 and all(r > 0 for r in rtfs)


def test_aggregate_logits_match_jax():
    rng = np.random.default_rng(44)
    B, T, V = 4, 17, 9
    logits = (rng.normal(size=(B, T, V)) * 2).astype(np.float32)
    aligns = rng.integers(0, 4, size=(B, T)).astype(np.int32)
    aligns[1, 3:8] = [2, 0, 2, 2, 0]  # a blank gap between equal tokens: two segments
    aligns[2, :] = 0  # a fully blank row
    for b in range(B):
        tp, tv = correct.aggregate_logits(logits[b], aligns[b], 0)
        jtp, jtv = jax_correct.aggregate_logits(logits[b], aligns[b], 0)
        np.testing.assert_allclose(tp.reshape(-1), np.asarray(jtp).reshape(-1), rtol=1e-5)
        np.testing.assert_allclose(tv, jtv, rtol=1e-5)
    jtp, jconf = (np.asarray(a) for a in jax_correct.aggregate_logits_device(jnp.asarray(logits),
                                                                             jnp.asarray(aligns), 0))
    for k in (None, 6):
        tp, conf = (a.numpy() for a in correct.aggregate_logits_device(T_(logits), T_(aligns), 0, k))
        K = T if k is None else k
        assert tp.shape == (B, K, V) and conf.shape == (B, K)
        np.testing.assert_array_equal(np.isfinite(conf), np.isfinite(jconf[:, :K]))
        live = np.isfinite(conf)
        np.testing.assert_allclose(conf[live], jconf[:, :K][live], rtol=1e-5)
        np.testing.assert_allclose(tp[live], jtp[:, :K][live], rtol=1e-5)
    assert not np.isfinite(conf[2]).any()


V, F, T, NP = 12, 8, 24, 9
ASR_CONF = dict(encoder_type="transformer", decoder_type="ctc", input_layer="linear", feat_dim=F,
                enc_hidden_size=16, enc_num_attention_heads=2, enc_num_layers=2, enc_intermediate_size=32,
                vocab_size=V, buckets=[[T, 8]], batch_size=5, max_xlens_batch=512, max_ylens_batch=64,
                dropout_enc_rate=0.0, dropout_attn_rate=0.0, mtl_phone_ctc_weight=0.3, hie_mtl_phone=True,
                inter_ctc_layer_id=1, phone_vocab_size=NP, phone_eos_id=2)
LM_SIZES = dict(vocab_size=V, mask_id=V - 1, eos_id=2, blank_id=0, max_seq_len=64, src_vocab_size=NP + 1,
                hidden_size=16, num_layers=1, num_attention_heads=2, intermediate_size=32,
                enc_hidden_size=16, enc_num_attention_heads=2, enc_num_layers=1, enc_intermediate_size=32,
                dec_hidden_size=16, dec_num_attention_heads=2, dec_num_layers=1, dec_intermediate_size=32,
                dropout_enc_rate=0.0, dropout_dec_rate=0.0, dropout_attn_rate=0.0)


def _setup(tmp_path):
    """Five utterances of random features with word and phone columns, the
    vocabularies, and an ASR model (hierarchical phone CTC) as a torch
    `state_dict` file, which both packages read."""
    rng = np.random.default_rng(0)
    feat_dir = tmp_path / "feats"
    feat_dir.mkdir()
    rows = []
    for i in range(5):
        np.save(feat_dir / f"u{i}.npy", rng.normal(size=(T, F)).astype(np.float32))
        rows.append(dict(feat_path=str(feat_dir / f"u{i}.npy"), utt_id=f"s-u{i}-{i}00-{i}99",
                         token_id="3 4 5", text="w3 w4 w5", xlen=T, ylen=3,
                         phone_token_id="3 4 5 6 7 8", phone_text="p3 p4 p5 p6 p7 p8"))
    tsv = tmp_path / "test.tsv"
    pd.DataFrame(rows).to_csv(tsv, sep="\t", index=False)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["<blank> 0", "<unk> 1", "<eos> 2"] + [f"▁w{i} {i}" for i in range(3, V)]) + "\n",
                     encoding="utf-8")
    pvocab = tmp_path / "vocab_phone.txt"
    pvocab.write_text("\n".join(["<blank> 0", "<unk> 1", "<eos> 2"] + [f"▁p{i} {i}" for i in range(3, NP)]) + "\n",
                      encoding="utf-8")
    conf = dict(ASR_CONF, vocab_path=str(vocab), phone_vocab_path=str(pvocab), test_path=str(tsv))
    conf_path = tmp_path / "corr.yaml"
    conf_path.write_text(yaml.safe_dump(conf))
    jcfg = jax_config(conf)
    two = jnp.full((2,), 3, jnp.int32)
    toks = jnp.full((2, 3), 3, jnp.int32)
    shapes = jax.eval_shape(lambda: JaxASR(jcfg).init(  # the loss reaches both heads
        jax.random.PRNGKey(0), jnp.zeros((2, T, F)), jnp.full((2,), T, jnp.int32), toks, two, toks, toks,
        None, toks, two))
    params = redraw_params(shapes["params"], 45)
    save_state_dict(asr_state_dict(params, config_from_dict(conf)),
                    str(tmp_path / "corr" / "checkpoints" / "model.ep1"))
    return str(conf_path), str(tsv)


def _lm_checkpoints(tmp_path, lm_type, tsv, seed):
    """One LM's weights as the port's torch file (`<lm_type>.yaml`) and as
    the JAX package's orbax directory (`<lm_type>_jax.yaml`), the JAX CLI
    reading no torch file of a phone-to-word type."""
    conf = dict(LM_SIZES, lm_type=lm_type, test_path=tsv)
    params = jax_lm_params(conf, seed)
    sd = lm_state_dict(params, config_from_dict(conf))
    paths = {}
    for side in ("torch", "jax"):
        name = lm_type if side == "torch" else f"{lm_type}_jax"
        path = tmp_path / f"{name}.yaml"
        path.write_text(yaml.safe_dump(conf))
        paths[side] = str(path)
        if side == "torch":
            save_state_dict({f"lm.{k}": v for k, v in sd.items()}, str(tmp_path / name / "checkpoints" / "model.ep1"))
        else:
            os.makedirs(tmp_path / name / "checkpoints")
            jax_ckpt.save_model(str(tmp_path / name / "checkpoints" / "model.ep1"), params, {})
    return paths


@pytest.mark.parametrize("lm_type,mask_th", [("bert", 0.3), ("pbert", 0.9), ("pctc", 0.9)])
def test_correct_cli_matches_the_jax_cli(tmp_path, lm_type, mask_th):
    conf, tsv = _setup(tmp_path)
    lm = _lm_checkpoints(tmp_path, lm_type, tsv, seed=46)
    out = os.path.join(tmp_path, "corr", "results", f"result_correct_test_th{mask_th:.2f}_lm0.50_ep1.tsv")
    jargs = SimpleNamespace(conf=conf, ep="1", lm_conf=lm["jax"], lm_ep="1", mask_th=mask_th, lm_weight=0.5,
                            data=None, data_tag="test", debug=False, runtime=False, runtime_num_samples=20,
                            runtime_num_repeats=5, wavtime_factor=1000)
    jwer, jinfo = jax_correct.test_main(jargs)
    shutil.move(out, out + ".jax")
    wer, info = correct.main(["-conf", conf, "-ep", "1", "--lm_conf", lm["torch"], "--lm_ep", "1",
                              "--mask_th", str(mask_th), "--lm_weight", "0.5", "--cpu"])
    assert (wer, info) == (jwer, jinfo)
    got, want = pd.read_table(out, comment="#"), pd.read_table(out + ".jax", comment="#")
    assert len(got) == 5
    pd.testing.assert_frame_equal(got, want)
    assert open(out).readline() == open(out + ".jax").readline()  # the WER comment
    rtfs = correct.main(["-conf", conf, "-ep", "1", "--lm_conf", lm["torch"], "--lm_ep", "1", "--mask_th",
                         str(mask_th), "--runtime", "--runtime_num_repeats", "1", "--cpu"])
    assert len(rtfs) == 1 and rtfs[0] > 0


@pytest.mark.parametrize("beam", [0, 3])
def test_decode_phone_matches_the_jax_cli(tmp_path, beam):
    conf, _ = _setup(tmp_path)
    argv = ["-conf", conf, "-ep", "1", "--decode_phone", "--beam_width", str(beam)]
    res = os.path.join(tmp_path, "corr", "results", f"result_test_beam{beam}_len0.0_ctc0.0_lm0.00_ep1_phone.tsv")
    jout = jax_test_asr.test_main(jax_test_asr.build_argparser().parse_args(argv))
    shutil.move(res, res + ".jax")
    out = test_asr.main(argv + ["--cpu"])
    assert out[2:] == jout[2:] and out[3].startswith("PER")
    pd.testing.assert_frame_equal(pd.read_table(res, comment="#"), pd.read_table(res + ".jax", comment="#"))
    assert open(res).readline() == open(res + ".jax").readline()
    assert pd.read_table(res, comment="#")["reftext"].str.startswith("p3").all()  # the phone references
    nb = test_asr.main(argv + ["--cpu", "--nbest"])
    assert nb is None and os.path.exists(res.replace(".tsv", "_nbest.tsv"))
