"""The port's eval CLI against the JAX package's, on one port-written
`model.ep1` (a reference-layout torch `state_dict` file that the JAX CLI
imports through utils/torch_import.py).

- Single-bucket corpus: the result TSVs of the two CLIs agree row for row,
  greedy and beam 4, with `enc_fused_attn` on and off.  (One bucket, because
  the JAX loop misattributes rows after a padded tail batch when several
  buckets are evaluated; ROADMAP.md §3.)
- `--nbest` writes the same hypotheses as the JAX CLI; `--runtime` runs.
- Several buckets with padded tail batches: the port's rows equal the JAX
  decode function applied batch by batch, each batch paired with its own
  utterance ids.
- The port's WER equals the JAX `compute_wers_df`; epoch averaging gives
  the same weights as the JAX package's.
- A tiny L3-1 model (Conformer encoder, Transformer decoder, joint CTC 0.3,
  length weight 2, beam 3, one layer each, d=32, V=50): the two CLIs write the
  same TSV, top-1 and `--nbest`, with `dec_step_mode` auto and fused_indirect.
- The same model decoded as L3-3, with a tiny Transformer LM fused at weight
  0.5 (`--lm_weight 0.5 --lm_conf <lm yaml> --lm_ep 1`; the port's fused LM
  step on): the two CLIs write the same TSV under the same name.

Sizes: 2 layers, d=32, 4 heads, F=20, V=300; weights and features from
numpy seeds.  Tolerance: exact (token ids, text, WER line), except n-best
scores (atol 1e-4: logsumexp merges in two frameworks)."""

import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from emoasr_tpu.config import load_config as jax_load_config
from emoasr_tpu.eval import test_asr as jax_cli
from emoasr_tpu.eval.decode import build_decode_fn as jax_build_decode_fn
from emoasr_tpu.eval.wer import compute_wers_df as jax_compute_wers_df
from emoasr_tpu.eval.wer import wer_info_line as jax_wer_info_line
from emoasr_tpu.models.asr import ASR as JaxASR
from emoasr_tpu.train import checkpoint as jax_ckpt
from emoasr_tpu.utils.vocab import Vocab as JaxVocab
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.eval import test_asr as port_cli
from emoasr_tpu_torch.eval.wer import compute_wers_df, wer_info_line
from emoasr_tpu_torch.ops import attention, topk
from emoasr_tpu_torch.train import checkpoint as port_ckpt
from emoasr_tpu_torch.utils.flax_import import asr_state_dict
from test_torch_conformer import L3_SMALL, random_l3_params
from test_torch_encoder import SMALL, random_flax_params
from test_torch_lm import LM_SMALL, lm_pair

V, F = 300, 20


def _corpus(root, lengths, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "feats"), exist_ok=True)
    rows = []
    for i, T in enumerate(lengths):
        U = int(rng.integers(2, 6))
        path = os.path.join(root, "feats", f"utt{i}.npy")
        np.save(path, rng.normal(size=(T, F)).astype(np.float32))
        toks = rng.integers(3, V, size=U)
        rows.append(dict(
            feat_path=path, utt_id=f"spk-utt{i}-{i * 1000}-{i * 1000 + T * 10}",
            token_id=" ".join(map(str, toks)), text=" ".join(f"w{t}" for t in toks),
            xlen=T, ylen=U,
        ))
    tsv = os.path.join(root, "test.tsv")
    pd.DataFrame(rows).to_csv(tsv, sep="\t", index=False)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w", encoding="utf-8") as f:
        f.write("\n".join(["<blank> 0", "<unk> 1", "<eos> 2"] + [f"▁w{i} {i}" for i in range(3, V)]) + "\n")
    return tsv, vocab


def _experiment(root, name, tsv, vocab, params, base=SMALL, batch_stats=None, **over):
    conf = dict(base, vocab_path=vocab, test_path=tsv, batch_size=4,
                max_xlens_batch=4000, max_ylens_batch=400)
    conf.update(over)
    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(conf, f)
    sd = asr_state_dict(params, config_from_dict(conf), batch_stats)
    port_ckpt.save_state_dict(sd, os.path.join(root, name, "checkpoints", "model.ep1"))
    return path


def _tsv(conf, sub, beam):
    path = os.path.join(os.path.splitext(conf)[0], "results", sub,
                        f"result_test_beam{beam}_len0.0_ctc0.0_lm0.00_ep1.tsv")
    with open(path) as f:
        comment = f.readline()
    return pd.read_table(path, comment="#"), comment


@pytest.fixture(scope="module")
def params():
    return random_flax_params(SMALL, seed=7)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("beam", [0, 4])
def test_cli_matches_jax_cli(tmp_path, params, fused, beam):
    tsv, vocab = _corpus(str(tmp_path), [60, 75, 90, 101, 120])  # one bucket
    conf = _experiment(str(tmp_path), "exp", tsv, vocab, params,
                       enc_fused_attn=fused, buckets=[[128, 16]], batch_size=8)
    argv = ["-conf", conf, "-ep", "1", "--beam_width", str(beam)]
    jax_cli.test_main(jax_cli.build_argparser().parse_args(argv + ["--save_dir", "jax"]))
    out = port_cli.main(argv + ["--cpu", "--save_dir", "torch"])
    ref, ref_comment = _tsv(conf, "jax", beam)
    got, got_comment = _tsv(conf, "torch", beam)
    assert len(got) == 5
    pd.testing.assert_frame_equal(got, ref)
    assert got_comment == ref_comment and got_comment.startswith("# WER:")
    assert out[3] == got_comment[2:].strip()
    assert topk.KERNEL.launches == 0 and attention.KERNEL.launches == 0


def test_cli_nbest_and_runtime(tmp_path, params):
    """--nbest: the same surviving hypotheses as the JAX CLI (scores atol
    1e-4, the beam's logsumexp merges); --runtime: every sampled utterance
    decoded."""
    tsv, vocab = _corpus(str(tmp_path), [60, 75, 90, 101, 120])
    conf = _experiment(str(tmp_path), "exp", tsv, vocab, params,
                       enc_fused_attn=True, buckets=[[128, 16]], batch_size=8)
    argv = ["-conf", conf, "-ep", "1", "--beam_width", "4", "--nbest"]
    jax_cli.test_main(jax_cli.build_argparser().parse_args(argv + ["--save_dir", "jax"]))
    assert port_cli.main(argv + ["--cpu", "--save_dir", "torch"]) is None
    res = os.path.join(os.path.splitext(conf)[0], "results")
    name = "result_test_beam4_len0.0_ctc0.0_lm0.00_ep1_nbest.tsv"
    ref = pd.read_table(os.path.join(res, "jax", name))
    got = pd.read_table(os.path.join(res, "torch", name))
    assert len(got) >= 5 and list(got.columns) == list(ref.columns)
    pd.testing.assert_frame_equal(got.drop(columns="score_asr"), ref.drop(columns="score_asr"))
    np.testing.assert_allclose(got["score_asr"], ref["score_asr"], atol=1e-4, rtol=0)

    runtimes, rtfs, n_decoded = port_cli.main([
        "-conf", conf, "-ep", "1", "--cpu", "--beam_width", "4", "--runtime",
        "--runtime_num_samples", "3", "--runtime_num_repeats", "2",
    ])
    assert len(runtimes) == len(rtfs) == 2 and min(rtfs) > 0
    assert n_decoded == 3


@pytest.mark.parametrize("beam", [0, 4])
def test_rows_paired_across_buckets(tmp_path, params, beam):
    """Buckets of 64 and 128 frames, batches of 4: each bucket ends in a
    padded tail batch, and every row must keep its own utterance id."""
    lengths = [40, 50, 60, 45, 55, 100, 110, 120, 105, 115, 125]
    tsv, vocab = _corpus(str(tmp_path), lengths, seed=1)
    conf = _experiment(str(tmp_path), "exp", tsv, vocab, params,
                       enc_fused_attn=True, buckets=[[64, 16], [128, 16]])
    port_cli.main(["-conf", conf, "-ep", "1", "--cpu", "--beam_width", str(beam)])
    got, _ = _tsv(conf, "", beam)

    jcfg = jax_load_config(conf)
    variables = jax_cli.load_asr_variables(
        os.path.join(os.path.splitext(conf)[0], "checkpoints", "model.ep1"), jcfg
    )
    decode = jax_build_decode_fn(JaxASR(jcfg), variables, jcfg, beam)
    dataset = jax_cli.ASRDataset(jcfg, tsv, phase="test")
    vocab_j = JaxVocab(vocab)
    want, n_batches = [], 0
    for batch in dataset.batches(dataset.make_batcher(shuffle=False, drop_tail=False)):
        hyps, hyp_lens, scores = (np.asarray(x) for x in decode(jnp.asarray(batch["xs"]), jnp.asarray(batch["xlens"])))
        rows, _, _ = jax_cli._postproc_batch(
            jcfg, batch, hyps, hyp_lens, scores, vocab_j, False, False, None
        )
        want.extend(rows)
        n_batches += 1
    assert n_batches == 4
    want = pd.DataFrame(want, columns=["utt_id", "token_id", "text", "reftext"])
    assert sorted(got["utt_id"]) == sorted(want["utt_id"]) and len(got) == len(lengths)
    key = lambda df: df.sort_values("utt_id").reset_index(drop=True).fillna("")
    pd.testing.assert_frame_equal(key(got).astype(str), key(want).astype(str))


def test_wer_matches_jax():
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(8)]
    rows = []
    for i in range(30):
        ref = list(rng.choice(words, size=int(rng.integers(1, 9))))
        hyp = [w for w in ref if rng.random() > 0.2] + list(rng.choice(words, size=int(rng.integers(0, 3))))
        rows.append([f"u{i}", "", " ".join(hyp) if hyp else np.nan, " ".join(ref)])
    df = pd.DataFrame(rows, columns=["utt_id", "token_id", "text", "reftext"])
    wer, wd = compute_wers_df(df)
    jwer, jwd = jax_compute_wers_df(df)
    assert wer == jwer and wd == jwd
    assert wer_info_line(wer, wd) == jax_wer_info_line(jwer, jwd)


def test_epoch_average_matches_jax(tmp_path):
    conf = str(tmp_path / "exp.yaml")
    ck = tmp_path / "exp" / "checkpoints"
    g = torch.Generator().manual_seed(0)
    for ep in (1, 2, 3):
        sd = {"a.weight": torch.randn(5, 3, generator=g), "n.num_batches_tracked": torch.tensor(ep)}
        port_ckpt.save_state_dict(sd, str(ck / f"model.ep{ep}"))
    port_ckpt.model_average(conf, "1-3")
    mine = port_ckpt.load_state_dict(str(ck / "model.ep1-3"))
    jax_ckpt._model_average_torch(conf, [1, 2, 3], str(ck / "jax_avg"))
    ref = port_ckpt.load_state_dict(str(ck / "jax_avg"))
    assert set(mine) == set(ref)
    assert torch.equal(mine["a.weight"], ref["a.weight"])
    # integer buffers come from the first epoch; the JAX side also turns a
    # 0-d buffer into shape (1,) (np.ascontiguousarray), the port keeps 0-d
    assert mine["n.num_batches_tracked"].shape == ()
    assert mine["n.num_batches_tracked"].item() == ref["n.num_batches_tracked"].item() == 1
    assert port_ckpt.parse_epochs("91-100") == list(range(91, 101))
    assert port_ckpt.parse_epochs("1+2+5") == [1, 2, 5]
    assert port_ckpt.parse_epochs("7") is None


@pytest.mark.parametrize("mode", ["auto", "fused_indirect"])
def test_l3_1_cli_matches_jax_cli(tmp_path, mode):
    """Conformer + Transformer decoder with joint CTC: top-1 rows equal (the
    `top1` early stop on both sides), then `--nbest` (scores atol 1e-4)."""
    base = dict(L3_SMALL, enc_num_layers=1, dec_num_layers=1, beam_width=3, len_weight=2.0,
                decode_ctc_weight=0.3, max_decode_ylen=10)
    l3_params, l3_stats = random_l3_params(base, seed=11)
    l3_params["decoder"]["output"]["bias"][2] += 3.0  # beams do end
    tsv, vocab = _corpus(str(tmp_path), [60, 75, 90, 101, 120])  # one bucket
    conf = _experiment(str(tmp_path), "l3", tsv, vocab, l3_params, base=base, batch_stats=l3_stats,
                       dec_step_mode=mode, enc_fused_attn=True, buckets=[[128, 16]], batch_size=8)
    argv = ["-conf", conf, "-ep", "1"]
    jax_cli.test_main(jax_cli.build_argparser().parse_args(argv + ["--save_dir", "jax"]))
    out = port_cli.main(argv + ["--cpu", "--save_dir", "torch"])
    res = os.path.join(os.path.splitext(conf)[0], "results")
    name = "result_test_beam3_len2.0_ctc0.3_lm0.00_ep1.tsv"
    ref = pd.read_table(os.path.join(res, "jax", name), comment="#")
    got = pd.read_table(os.path.join(res, "torch", name), comment="#")
    assert len(got) == 5 and got["token_id"].notna().all()
    pd.testing.assert_frame_equal(got, ref)
    with open(os.path.join(res, "torch", name)) as f, open(os.path.join(res, "jax", name)) as g:
        assert f.readline() == g.readline() == "# " + out[3] + "\n"

    argv += ["--nbest", "--decode_ctc_weight", "0.3", "--beam_width", "3"]
    jax_cli.test_main(jax_cli.build_argparser().parse_args(argv + ["--save_dir", "jax"]))
    assert port_cli.main(argv + ["--cpu", "--save_dir", "torch"]) is None
    name = name.replace(".tsv", "_nbest.tsv")
    ref = pd.read_table(os.path.join(res, "jax", name))
    got = pd.read_table(os.path.join(res, "torch", name))
    assert len(got) > 5 and list(got.columns) == list(ref.columns)
    pd.testing.assert_frame_equal(got.drop(columns="score_asr"), ref.drop(columns="score_asr"))
    np.testing.assert_allclose(got["score_asr"], ref["score_asr"], atol=1e-4, rtol=0)


def test_l3_3_cli_with_lm_matches_jax_cli(tmp_path, monkeypatch):
    """Joint CTC 0.3 and Transformer-LM shallow fusion 0.5 through both CLIs:
    the same rows, WER line and file name (`..._lm0.50transformer_ep1.tsv`).
    The port runs the fused decoder and LM steps (their plain versions on
    the CPU), the JAX CLI its fused decoder step and its dense LM step."""
    import emoasr_tpu_torch.models.lm.bert as bert_mod

    base = dict(L3_SMALL, enc_num_layers=1, dec_num_layers=1, beam_width=3, len_weight=2.0,
                decode_ctc_weight=0.3, max_decode_ylen=10)
    l3_params, l3_stats = random_l3_params(base, seed=12)
    l3_params["decoder"]["output"]["bias"][2] += 3.0  # beams do end
    tsv, vocab = _corpus(str(tmp_path), [60, 75, 90, 101, 120])  # one bucket
    conf = _experiment(str(tmp_path), "l3", tsv, vocab, l3_params, base=base, batch_stats=l3_stats,
                       dec_step_mode="fused_indirect", enc_fused_attn=True, buckets=[[128, 16]], batch_size=8)
    lm_conf = dict(LM_SMALL, vocab_size=50)
    _, _, lm = lm_pair(lm_conf, seed=13)
    lm_path = os.path.join(str(tmp_path), "lm.yaml")
    with open(lm_path, "w") as f:
        yaml.safe_dump(lm_conf, f)
    port_ckpt.save_state_dict(lm.state_dict(), os.path.join(str(tmp_path), "lm", "checkpoints", "model.ep1"))

    argv = ["-conf", conf, "-ep", "1", "--lm_weight", "0.5", "--lm_conf", lm_path, "--lm_ep", "1"]
    jax_cli.test_main(jax_cli.build_argparser().parse_args(argv + ["--save_dir", "jax"]))
    monkeypatch.setattr(bert_mod, "FUSED_INDIRECT_STEP", True)
    out = port_cli.main(argv + ["--cpu", "--save_dir", "torch"])
    assert out[0] == 0.5 and out[1] == 2.0
    res = os.path.join(os.path.splitext(conf)[0], "results")
    name = "result_test_beam3_len2.0_ctc0.3_lm0.50transformer_ep1.tsv"
    assert os.listdir(os.path.join(res, "torch")) == os.listdir(os.path.join(res, "jax")) == [name]
    ref = pd.read_table(os.path.join(res, "jax", name), comment="#")
    got = pd.read_table(os.path.join(res, "torch", name), comment="#")
    assert len(got) == 5 and got["token_id"].notna().all()
    pd.testing.assert_frame_equal(got, ref)
    with open(os.path.join(res, "torch", name)) as f, open(os.path.join(res, "jax", name)) as g:
        assert f.readline() == g.readline() == "# " + out[3] + "\n"


@pytest.mark.parametrize("beam", [0, 4])
def test_l4_rnnt_cli_matches_jax_cli(tmp_path, beam):
    """A tiny RNN-T(Conformer) model: greedy and the ALSD beam at width 4,
    the same TSV rows and WER line as the JAX CLI."""
    from test_torch_rnnt import RNNT_SMALL, random_rnnt_params

    base = dict(RNNT_SMALL, enc_num_layers=1, dec_num_layers=1, mtl_ctc_weight=0.0, max_decode_ylen=10)
    params, stats = random_rnnt_params(base, seed=14)
    tsv, vocab = _corpus(str(tmp_path), [60, 75, 90, 101, 120])  # one bucket
    conf = _experiment(str(tmp_path), "l4", tsv, vocab, params, base=base, batch_stats=stats,
                       enc_fused_attn=True, buckets=[[128, 16]], batch_size=8)
    argv = ["-conf", conf, "-ep", "1", "--beam_width", str(beam)]
    jax_cli.test_main(jax_cli.build_argparser().parse_args(argv + ["--save_dir", "jax"]))
    out = port_cli.main(argv + ["--cpu", "--save_dir", "torch"])
    ref, ref_comment = _tsv(conf, "jax", beam)
    got, got_comment = _tsv(conf, "torch", beam)
    assert len(got) == 5 and got["token_id"].notna().any()
    pd.testing.assert_frame_equal(got, ref)
    assert got_comment == ref_comment == "# " + out[3] + "\n"
