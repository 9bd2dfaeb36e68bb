"""The slice's tools in the port against the JAX package, on the CPU, and the
distillation pipeline as a whole.

- `make_label` with a causal (Transformer) LM and with BERT, both branches
  of `add_sos_eos` framing (short rows and rows past `max_seq_len - 2`) and
  the position-0 hard label, over several chunks: the pickles equal JAX's
  (ids exactly, probabilities within 1e-6), on one LM checkpoint that both
  CLIs read; `accuracy` and the `eval` CLI print the same lines.
- `analyse_ctc_prob` on a checkpoint the port wrote, against JAX's
  probabilities (1e-6); `compare_wer` and `alignment` (SI, SID): the same
  DataFrames.
- `fusion_grid.main` on a tiny CTC checkpoint and RNN LM the port wrote:
  the same best (WER, lm_weight, len_weight, line) as JAX's
  `fusion_grid.main` on them.
- The slice as a whole (the port of `tests/test_kd_pipeline.py`): LM ->
  `make_label` pickle -> `ASRDataset(kd_label_path=...)` -> one CTC
  alignment-KD train step on both sides from shared weights: each dataset
  reads the other package's pickle to the same soft labels, `loss_ctc`,
  `loss_kd` and `loss_total` within the train-step tests' rtol 2e-4, and
  the updated parameters within 1e-5 (entries whose gradient is rounding
  noise, by their second moment, within one LR, as
  `test_torch_lm_p2w_train.py` holds them).
"""

import os
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from emoasr_tpu.config import config_from_dict as jax_config
from emoasr_tpu.data.asr_dataset import ASRDataset as JaxASRDataset
from emoasr_tpu.eval import align_hyps as jax_align
from emoasr_tpu.eval import analysis as jax_analysis
from emoasr_tpu.eval import fusion_grid as jax_grid
from emoasr_tpu.eval import make_label as jax_make_label
from emoasr_tpu.eval import test_asr as jax_cli
from emoasr_tpu.models.asr import ASR as JaxASR
from emoasr_tpu.train import optim as joptim
from emoasr_tpu.train.step import init_train_state
from emoasr_tpu.train.step import make_train_step as jax_make_train_step
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.data.asr_dataset import ASRDataset
from emoasr_tpu_torch.eval import align_hyps, analysis, fusion_grid, make_label
from emoasr_tpu_torch.eval import test_asr as port_cli
from emoasr_tpu_torch.models.asr import ASR
from emoasr_tpu_torch.ops import topk
from emoasr_tpu_torch.train import optim
from emoasr_tpu_torch.train.checkpoint import save_state_dict
from emoasr_tpu_torch.train.step import TrainState, make_train_step
from emoasr_tpu_torch.utils.flax_import import asr_state_dict, lm_state_dict
from test_torch_encoder import random_flax_params
from test_torch_lm_types import FIX_BERT, random_lm_params

PROB_TOL = 1e-6
STEP_RTOL = 2e-4
V = 40


def _write_vocab(path, V):
    path.write_text("\n".join(["<blank> 0", "<unk> 1", "<eos> 2"] + [f"▁w{i} {i}" for i in range(3, V)]) + "\n",
                    encoding="utf-8")
    return str(path)


def _write_lm(tmp_path, name, conf, seed):
    """An LM yaml and its `model.ep1` (a torch state_dict from JAX
    parameters, through `flax_import`), which both packages' loaders read."""
    conf_path = tmp_path / f"{name}.yaml"
    conf_path.write_text(yaml.safe_dump(conf))
    params = random_lm_params(conf, seed)
    (tmp_path / name / "checkpoints").mkdir(parents=True)
    save_state_dict(lm_state_dict(params, config_from_dict(conf)), str(tmp_path / name / "checkpoints" / "model.ep1"))
    return str(conf_path), params


def _label_rows(rng, n, max_len, bert: bool, mask_id=39):
    """Rows of ids 3..V-2; causal rows label [start_pos, end_pos) (some from
    0: the hard label), BERT rows carry a masked `mask_pos`."""
    rows = []
    for i in range(n):
        L = int(rng.integers(3, max_len + 1))
        ids = rng.integers(3, V - 1, size=L)
        row = dict(utt_id=f"utt{i % (n - 3)}")
        if bert:
            pos = int(rng.integers(0, L))
            ids[pos] = mask_id
            row["mask_pos"] = pos
        else:
            row["start_pos"] = 0 if i % 3 == 0 else int(rng.integers(1, L))
            row["end_pos"] = L
        row["token_id"] = " ".join(map(str, ids))
        rows.append(row)
    return pd.DataFrame(rows)


def _assert_same_labels(got: dict, want: dict):
    assert got.keys() == want.keys() and got
    for utt in want:
        assert len(got[utt]) == len(want[utt]), utt
        for g, w in zip(got[utt], want[utt]):
            assert [v for v, _ in g] == [v for v, _ in w], utt
            np.testing.assert_allclose([p for _, p in g], [p for _, p in w], rtol=0, atol=PROB_TOL)


@pytest.mark.parametrize("lm_type,add_sos_eos", [("transformer", False), ("transformer", True), ("bert", True)])
def test_make_label_cli_matches_jax(tmp_path, monkeypatch, capsys, lm_type, add_sos_eos):
    """Both CLIs over one checkpoint, in chunks of 4 rows; max_seq_len 12
    puts the longer rows (11-12 ids) on `_frame`'s second branch."""
    for mod in (make_label, jax_make_label):
        monkeypatch.setattr(mod, "BATCH_SIZE", 4)
    conf = dict(FIX_BERT, lm_type=lm_type, max_seq_len=12, add_sos_eos=add_sos_eos, num_layers=1)
    lm_conf, _ = _write_lm(tmp_path, "lm", conf, seed=3)
    df = _label_rows(np.random.default_rng(7), 13, 12, bert=lm_type == "bert")
    data = str(tmp_path / "rows.tsv")
    df.to_csv(data, sep="\t", index=False)
    jpkl, tpkl = str(tmp_path / "jax.pkl"), str(tmp_path / "torch.pkl")
    jax_make_label.main(SimpleNamespace(lm_conf=lm_conf, lm_ep="1", data=data, save_path=jpkl, topk=8, temp=3.0))
    topk.KERNEL.reset_counts()
    make_label.cli(["make", "-lm_conf", lm_conf, "-lm_ep", "1", "-data", data, "-save_path", tpkl, "--cpu"])
    assert topk.KERNEL.launches == 0  # CPU tensors: the plain version
    with open(jpkl, "rb") as f:
        want = pickle.load(f)
    with open(tpkl, "rb") as f:
        got = pickle.load(f)
    _assert_same_labels(got, want)
    flat = [lab for labs in got.values() for lab in labs]
    if lm_type == "transformer" and not add_sos_eos:
        assert [lab for lab in flat if len(lab) == 1 and lab[0][1] == 1.0]  # position 0's hard label
    if add_sos_eos:
        assert all(v != 2 for lab in flat for v, _ in lab)  # <eos> entries left out
    if lm_type == "transformer" and add_sos_eos:
        # a long row labelled from 0 takes its framed <eos> as the hard label, left out: an empty
        # label, on which `accuracy` fails on both sides; nothing more to compare
        assert [] in flat
        return
    # accuracy against a reference of 5s for each utterance
    refs = pd.DataFrame([dict(utt_id=u, token_id=" ".join(["5"] * 40)) for u in got])
    ref_tsv = str(tmp_path / "ref.tsv")
    refs.to_csv(ref_tsv, sep="\t", index=False)
    capsys.readouterr()
    jax_make_label.eval_label_main(SimpleNamespace(pkl_path=jpkl, ref=ref_tsv))
    jout = capsys.readouterr().out
    assert make_label.cli(["eval", tpkl, "-ref", ref_tsv]) == jax_make_label.accuracy(want, refs)
    assert capsys.readouterr().out == jout and "tokens" in jout


def _asr_setup(tmp_path, n_utts=6, V=12, F=8, T=24):
    """A tiny CTC(Transformer) yaml, the port's `model.ep1`, a test TSV
    and its vocabulary."""
    rng = np.random.default_rng(0)
    (tmp_path / "feats").mkdir()
    rows = []
    for i in range(n_utts):
        np.save(tmp_path / "feats" / f"u{i}.npy", rng.normal(size=(T, F)).astype(np.float32))
        toks = rng.integers(3, V, size=3)
        rows.append(dict(feat_path=str(tmp_path / "feats" / f"u{i}.npy"), utt_id=f"s-u{i}-{i}00-{i}99",
                         token_id=" ".join(map(str, toks)), text=" ".join(f"w{t}" for t in toks), xlen=T, ylen=3))
    tsv = tmp_path / "test.tsv"
    pd.DataFrame(rows).to_csv(tsv, sep="\t", index=False)
    conf = dict(encoder_type="transformer", decoder_type="ctc", input_layer="linear", feat_dim=F, enc_hidden_size=16,
                enc_num_attention_heads=2, enc_num_layers=1, enc_intermediate_size=32, vocab_size=V,
                vocab_path=_write_vocab(tmp_path / "vocab.txt", V), test_path=str(tsv), buckets=[[T, n_utts]],
                batch_size=n_utts, max_xlens_batch=512, max_ylens_batch=64, dropout_enc_rate=0.0,
                dropout_attn_rate=0.0)
    conf_path = tmp_path / "asr.yaml"
    conf_path.write_text(yaml.safe_dump(conf))
    cfg = config_from_dict(conf)
    model = ASR(cfg)
    model.load_state_dict(asr_state_dict(random_flax_params(conf, seed=5), cfg))
    (tmp_path / "asr" / "checkpoints").mkdir(parents=True)
    save_state_dict(model.state_dict(), str(tmp_path / "asr" / "checkpoints" / "model.ep1"))
    return str(conf_path), rows, V


def test_analyse_ctc_prob_matches_jax(tmp_path, capsys):
    conf, rows, _ = _asr_setup(tmp_path)
    utt = rows[2]["utt_id"]
    want = jax_analysis.analyse_ctc_prob(conf, "1", utt, 3)
    jout = capsys.readouterr().out
    got = analysis.main(["ctc_prob", "-conf", conf, "-ep", "1", "-utt_id", utt, "--topk", "3", "--cpu"])
    out = capsys.readouterr().out
    assert got.shape == np.asarray(want).shape == (24, 12)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=PROB_TOL)
    assert len(out.splitlines()) == len(jout.splitlines()) == 24


def test_compare_wer_and_alignment_match_jax(tmp_path):
    res = [dict(utt_id="u1", token_id="3 4", text="a b", reftext="a b"),
           dict(utt_id="u2", token_id="3 4 5", text="a b c", reftext="a b d"),
           dict(utt_id="u3", token_id="5", text="c", reftext="c")]
    res2 = [dict(res[0], text="a X"), dict(res[1], text="a b d"), dict(res[2])]
    p1, p2 = str(tmp_path / "r1.tsv"), str(tmp_path / "r2.tsv")
    pd.DataFrame(res).to_csv(p1, sep="\t", index=False)
    pd.DataFrame(res2).to_csv(p2, sep="\t", index=False)
    for show_all in (False, True):
        got = analysis.compare_wer(p1, p2, show_all)
        pd.testing.assert_frame_equal(got, jax_analysis.compare_wer(p1, p2, show_all))
        assert len(got) == (3 if show_all else 2)

    dfref = pd.DataFrame([dict(utt_id="u1", token_id="3 4 5 6"), dict(utt_id="u2", token_id="7 8")])
    hyps = ["3 9 5 6", "3 4 9 5 6", "3 5 6", "4 5", "3 4 5 6 10 11", "7", "8 7 8"]
    dfhyp = pd.DataFrame([dict(utt_id="u2" if h.startswith(("7", "8")) else "u1", score_asr=-float(i), token_id=h,
                               text=h, reftext="r") for i, h in enumerate(hyps)])
    for align_type in ("SI", "SID"):
        got = align_hyps.alignment(dfhyp, dfref, align_type, len_min=2, len_max=5)
        pd.testing.assert_frame_equal(got, jax_align.alignment(dfhyp, dfref, align_type, len_min=2, len_max=5))
        assert len(got) == 5
    # the CLI writes <tsv>_SIDalign.tsv
    nbest = str(tmp_path / "nbest.tsv")
    dfhyp.to_csv(nbest, sep="\t", index=False)
    ref_tsv = str(tmp_path / "ref.tsv")
    dfref.to_csv(ref_tsv, sep="\t", index=False)
    out = align_hyps.main(align_hyps.build_argparser().parse_args([nbest, "-ref", ref_tsv]))
    assert out.endswith("nbest_SIDalign.tsv") and len(pd.read_table(out)) == 7  # len_min 1, len_max 256


def test_fusion_grid_matches_jax(tmp_path):
    conf, _, Vs = _asr_setup(tmp_path)
    lm_conf = dict(lm_type="rnn", vocab_size=Vs, embedding_size=8, hidden_size=12, num_layers=1, dropout_rate=0.0)
    lm_conf_path, _ = _write_lm(tmp_path, "lm", lm_conf, seed=2)
    grid = ["-conf", conf, "-ep", "1", "--beam_width", "3", "--lm_conf", lm_conf_path, "--lm_ep", "1",
            "--lm_min", "0", "--lm_max", "0.5", "--lm_step", "0.5", "--len_min", "0", "--len_max", "1", "--cpu"]
    port_cli._SETUP_CACHE.clear()
    got = fusion_grid.main(fusion_grid.parse_args(grid + ["--save_dir", "torch"]))
    jargs = SimpleNamespace(
        conf=conf, ep="1", beam_width=3, decode_ctc_weight=0.0, lm_conf=lm_conf_path, lm_ep="1", lm_tag=None,
        data=None, data_tag="test", save_dir="jax", cpu=False, nbest=False, debug=False, utt_id=None, runtime=False,
        len_weight=None, lm_weight=None, decode_phone=False, lm_min=0.0, lm_max=0.5, lm_step=0.5, len_min=0.0,
        len_max=1.0, len_step=1.0)
    jax_cli._SETUP_CACHE.clear()
    want = jax_grid.main(jargs)
    assert got == want
    res = os.path.join(os.path.splitext(conf)[0], "results")
    for name in sorted(os.listdir(os.path.join(res, "jax"))):  # every point's TSV
        pd.testing.assert_frame_equal(pd.read_table(os.path.join(res, "torch", name), comment="#"),
                                      pd.read_table(os.path.join(res, "jax", name), comment="#"))
    assert len(os.listdir(os.path.join(res, "torch"))) == 4


# ---------------------------------------------------------------- the slice as a whole

KD_CONF = dict(encoder_type="transformer", decoder_type="ctc", input_layer="linear", feat_dim=8, enc_hidden_size=16,
               enc_num_attention_heads=2, enc_num_layers=1, enc_intermediate_size=32, vocab_size=12,
               kd_weight=0.5, kd_ctc_position="all", reduce_main_loss_kd=False, lr_schedule_type="noam",
               learning_rate=1.0, num_warmup_steps=10, buckets=[[32, 8]], batch_size=8, max_xlens_batch=512,
               max_ylens_batch=64, dropout_enc_rate=0.0, dropout_attn_rate=0.0, spec_augment=False)


def test_kd_pipeline_matches_jax(tmp_path):
    V, F = 12, 8
    rng = np.random.default_rng(0)
    rows = []
    (tmp_path / "feats").mkdir()
    for i in range(8):
        T, U = 20, int(rng.integers(2, 5))
        np.save(tmp_path / "feats" / f"u{i}.npy", rng.normal(size=(T, F)).astype(np.float32))
        toks = rng.integers(3, V, size=U)
        rows.append(dict(feat_path=str(tmp_path / "feats" / f"u{i}.npy"), utt_id=f"u{i}-0-{T * 10}",
                         token_id=" ".join(map(str, toks)), text=" ".join(f"w{t}" for t in toks), xlen=T, ylen=U,
                         start_pos=0, end_pos=U))
    tsv = str(tmp_path / "train.tsv")
    pd.DataFrame(rows).to_csv(tsv, sep="\t", index=False)

    # the LM's soft labels, on each side
    lm_conf, lm_params = _write_lm(tmp_path, "lm", dict(FIX_BERT, lm_type="transformer", vocab_size=V, mask_id=V - 1,
                                                        num_layers=1), seed=4)
    port_lm, lm_cfg = port_cli.load_lm(lm_conf, str(tmp_path / "lm" / "checkpoints" / "model.ep1"))
    jlm, jvars, jlm_cfg = jax_cli.load_lm(lm_conf, str(tmp_path / "lm" / "checkpoints" / "model.ep1"))
    df = pd.read_table(tsv)
    tpkl, jpkl = str(tmp_path / "torch.pkl"), str(tmp_path / "jax.pkl")
    got_labels = make_label.make_lm_label(df, port_lm, tpkl, topk=4)
    want_labels = jax_make_label.make_lm_label(df, jlm, jvars, jpkl, topk=4)
    _assert_same_labels(got_labels, want_labels)

    # each dataset reads the other's pickle to the same soft labels
    cfg, jcfg = config_from_dict(KD_CONF), jax_config(KD_CONF)
    batch = ASRDataset(cfg, tsv, phase="train", kd_label_path=jpkl).collate(list(range(8)), 32, 8)
    jbatch = JaxASRDataset(jcfg, tsv, phase="train", kd_label_path=tpkl).collate(list(range(8)), 32, 8)
    np.testing.assert_allclose(batch["soft_labels"], jbatch["soft_labels"], rtol=0, atol=PROB_TOL)
    s = batch["soft_labels"][0, : batch["ylens"][0]].sum(-1)
    np.testing.assert_allclose(s, np.ones_like(s), rtol=1e-5)
    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    jarrays = {k: v for k, v in jbatch.items() if isinstance(v, np.ndarray)}

    # one alignment-KD train step from shared weights
    params = random_flax_params(KD_CONF, seed=6)
    tx = joptim.build_optimizer(jcfg)
    jstate = init_train_state(params, {}, tx)
    jstate, jm = jax_make_train_step(JaxASR(jcfg), jcfg, tx)(
        jstate, {k: jnp.asarray(v) for k, v in jarrays.items()}, jax.random.PRNGKey(1))
    model = ASR(cfg)
    model.load_state_dict(asr_state_dict(params, cfg))
    state = TrainState(model=model, optimizer=optim.build_optimizer(cfg, model.parameters()))
    m = make_train_step(cfg)(state, {k: torch.from_numpy(v.copy()) for k, v in arrays.items()})
    for k in ("loss_ctc", "loss_kd", "loss_total"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=STEP_RTOL, err_msg=k)
    assert np.isfinite(m["loss_kd"].item()) and m["loss_kd"].item() != 0.0
    assert state.step == int(jstate.step) == 1 and m["grad_finite"]
    # Adam's first step is lr * g / (|g| + eps): an entry whose gradient is rounding (a key's bias
    # shifts every score of a query alike) takes a step of either sign.  Entries whose root second
    # moment is below 1e-4 of the largest are held to one LR, the others to 1e-5.
    want = asr_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params), cfg)
    start = asr_state_dict(params, cfg)
    named = dict(model.named_parameters())
    root = {n: state.optimizer.state[p]["exp_avg_sq"].sqrt().numpy() for n, p in named.items()}
    floor = 1e-4 * max(float(r.max()) for r in root.values())
    for n, p in named.items():
        got, ref, ill = p.detach().numpy(), want[n].numpy(), root[n] < floor
        assert np.abs(got - start[n].numpy())[ill].max(initial=0) <= m["lr"] * (1 + 1e-2), n
        np.testing.assert_allclose(got[~ill], ref[~ill], rtol=0, atol=1e-5, err_msg=n)
        assert not np.array_equal(ref, start[n].numpy()), n  # it moved
