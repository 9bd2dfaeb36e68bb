"""The port's train CLI end to end on the CPU: the twin of
`tests/test_e2e_overfit.py::test_train_cli_then_eval_cli_overfits`.

- Synthetic corpus on disk -> port train CLI (`--cpu`) -> port eval CLI:
  WER must collapse below 15, with `enc_fused_attn` on and off; the JAX eval
  CLI decodes the port's `model.ep{N}` to the same result TSV (exact: token
  ids, text, WER line).
- `--resume` continues from `model.ep{N}` / `optim.ep{N}` with the same step
  and LR, and ends at exactly the weights of an uninterrupted run (the CPU
  run is deterministic; dropout and SpecAugment are off), the open gradient
  accumulation included.
- `compute_dtype: bfloat16`: the same overfit through both CLIs, the
  trainer's masters, moments and checkpoint float32.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from emoasr_tpu.eval import test_asr as jax_cli
from emoasr_tpu_torch.config import load_config
from emoasr_tpu_torch.eval import test_asr as port_cli
from emoasr_tpu_torch.train import loop
from emoasr_tpu_torch.train.checkpoint import load_state_dict
from emoasr_tpu_torch.train.optim import make_lr_fn
from emoasr_tpu_torch.utils.paths import get_resume_paths
from test_e2e_overfit import _make_corpus


def _conf(tsv, vocab, **over):
    conf = dict(
        encoder_type="transformer", decoder_type="ctc", input_layer="linear", feat_dim=16,
        enc_hidden_size=32, enc_num_attention_heads=2, enc_num_layers=1, enc_intermediate_size=64,
        vocab_size=12, vocab_path=vocab, train_path=tsv, test_path=tsv, buckets=[[32, 8]],
        batch_size=8, max_xlens_batch=512, max_ylens_batch=64, num_epochs=60, learning_rate=5.0,
        lr_schedule_type="noam", num_warmup_steps=60, dropout_enc_rate=0.0, dropout_attn_rate=0.0,
        spec_augment=False, clip_grad_norm=5.0, log_step=50, save_step=60, seed=0,
    )
    conf.update(over)
    return conf


def _result(conf_path, sub, ep):
    path = os.path.join(os.path.splitext(conf_path)[0], "results", sub,
                        f"result_test_beam0_len0.0_ctc0.0_lm0.00_ep{ep}.tsv")
    with open(path) as f:
        comment = f.readline()
    return pd.read_table(path, comment="#"), comment


@pytest.mark.parametrize("fused", [False, True])
def test_train_cli_then_eval_cli_overfits(tmp_path, fused):
    tsv, vocab = _make_corpus(tmp_path)
    conf_path = tmp_path / "overfit.yaml"
    conf_path.write_text(yaml.safe_dump(_conf(tsv, vocab, enc_fused_attn=fused, dev_path=tsv)))

    state = loop.main(["-conf", str(conf_path), "--cpu"])
    assert state.step == 60 * 4 and state.skipped == 0

    argv = ["-conf", str(conf_path), "-ep", "60", "--beam_width", "0"]
    out = port_cli.main(argv + ["--cpu", "--save_dir", "torch"])
    assert out is not None
    _, _, wer, wer_info = out
    assert wer < 15.0, wer_info
    log = (tmp_path / "overfit" / "log" / "train.log").read_text()
    assert "epoch 60 dev WER (greedy)" in log and "checkpoint saved" in log

    # the JAX eval CLI reads the port's checkpoint and writes the same table
    jax_cli.test_main(jax_cli.build_argparser().parse_args(argv + ["--save_dir", "jax"]))
    got, got_comment = _result(str(conf_path), "torch", 60)
    ref, ref_comment = _result(str(conf_path), "jax", 60)
    pd.testing.assert_frame_equal(got, ref)
    assert got_comment == ref_comment == f"# {wer_info}\n"


def test_bf16_train_cli_then_eval_cli_overfits(tmp_path):
    """Training in bf16 (the forward on a bf16 copy of the float32 masters)
    learns the small corpus as float32 does; the checkpoint holds the
    float32 masters, and the eval CLI decodes it in bf16."""
    tsv, vocab = _make_corpus(tmp_path)
    conf_path = tmp_path / "overfit_bf16.yaml"
    conf_path.write_text(yaml.safe_dump(_conf(tsv, vocab, enc_fused_attn=True, dev_path=tsv,
                                              compute_dtype="bfloat16")))
    state = loop.main(["-conf", str(conf_path), "--cpu"])
    assert state.step == 60 * 4 and state.skipped == 0
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    moments = [v for st in state.optimizer.state.values() for v in st.values() if torch.is_tensor(v) and v.dim()]
    assert moments and all(v.dtype == torch.float32 for v in moments)
    ckpt = load_state_dict(str(tmp_path / "overfit_bf16" / "checkpoints" / "model.ep60"))
    assert all(v.dtype == torch.float32 for v in ckpt.values() if v.is_floating_point())
    out = port_cli.main(["-conf", str(conf_path), "-ep", "60", "--beam_width", "0", "--cpu"])
    assert out is not None and out[2] < 15.0, out[3]
    assert "epoch 60 dev WER (greedy)" in (tmp_path / "overfit_bf16" / "log" / "train.log").read_text()


def test_resume_continues_to_the_same_weights(tmp_path):
    tsv, vocab = _make_corpus(tmp_path)
    over = dict(accum_grad=3, save_step=2, lr_schedule_type="epdecay", learning_rate=2e-3,
                num_warmup_steps=3, lr_decay_start_epoch=3, lr_decay_rate=0.8, weight_decay=1e-4)

    whole = tmp_path / "whole.yaml"
    whole.write_text(yaml.safe_dump(_conf(tsv, vocab, num_epochs=6, **over)))
    s_whole = loop.main(["-conf", str(whole), "--cpu"])

    parts = tmp_path / "parts.yaml"
    parts.write_text(yaml.safe_dump(_conf(tsv, vocab, num_epochs=4, **over)))
    s1 = loop.main(["-conf", str(parts), "--cpu"])
    # 4 epochs x 4 micro-steps at accum_grad 3: 5 updates and one open micro-step
    assert (s1.step, s1.mini_step) == (16, 1)
    assert get_resume_paths(str(parts))[2] == 4
    parts.write_text(yaml.safe_dump(_conf(tsv, vocab, num_epochs=6, **over)))
    s2 = loop.main(["-conf", str(parts), "--resume", "--cpu"])

    assert s2.step == s_whole.step == 24 and s2.skipped == 0
    assert s2.mini_step == s_whole.mini_step == 0
    assert s2.epoch_scale == pytest.approx(0.8 ** 4) and s_whole.epoch_scale == pytest.approx(0.8 ** 4)
    log = (tmp_path / "parts" / "log" / "train.log").read_text()
    assert "model loaded" in log and "optim loaded" in log
    resumed = log[log.index("optim loaded"):]  # the log file is appended to
    assert "epoch 5 done" in resumed and "epoch 6 done" in resumed and "epoch 4 done" not in resumed
    # the same LR as the uninterrupted run: the schedule's value at update 8, decayed 3 times
    lr = s2.optimizer.param_groups[0]["lr"]
    assert lr == s_whole.optimizer.param_groups[0]["lr"]
    assert lr == pytest.approx(make_lr_fn(load_config(str(parts)))(8, 0.8 ** 3))
    a = load_state_dict(str(tmp_path / "whole" / "checkpoints" / "model.ep6"))
    b = load_state_dict(str(tmp_path / "parts" / "checkpoints" / "model.ep6"))
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    first = load_state_dict(str(tmp_path / "parts" / "checkpoints" / "model.ep4"))
    assert any(not torch.equal(first[k], b[k]) for k in b)


def test_warm_start_from_model_path(tmp_path):
    tsv, vocab = _make_corpus(tmp_path, n_utts=8)
    a = tmp_path / "a.yaml"
    a.write_text(yaml.safe_dump(_conf(tsv, vocab, num_epochs=1, save_step=1)))
    loop.main(["-conf", str(a), "--cpu"])
    ckpt = str(tmp_path / "a" / "checkpoints" / "model.ep1")
    b = tmp_path / "b.yaml"
    b.write_text(yaml.safe_dump(_conf(tsv, vocab, num_epochs=1, save_step=1, model_path=ckpt, seed=3)))
    state = loop.train(str(b), device="cpu", max_steps=0)  # loads, takes no step, saves
    saved = load_state_dict(str(tmp_path / "b" / "checkpoints" / "model.ep1"))
    for k, v in load_state_dict(ckpt).items():
        assert torch.equal(v, saved[k]), k
    assert state.step == 0
    assert np.isfinite(sum(v.double().sum().item() for v in saved.values()))


def test_rnnt_train_cli_then_both_eval_clis(tmp_path):
    """A tiny RNN-T model (1 x 32 Transformer encoder, 1 x 32 LSTM
    prediction network, joint 32, `rnnt_joint_mode: pallas`) through the
    port's train CLI on the CPU: the greedy dev WER is logged each epoch,
    the loss falls, and the JAX eval CLI decodes the port's `model.ep{N}`
    to the port eval CLI's TSV, greedy and beam 3 (exact)."""
    tsv, vocab = _make_corpus(tmp_path)
    conf = _conf(tsv, vocab, decoder_type="rnn_transducer", dec_hidden_size=32, dec_num_layers=1,
                 joint_hidden_size=32, embedding_size=16, rnnt_joint_mode="pallas", num_epochs=24,
                 save_step=24, num_warmup_steps=40, dev_path=tsv, max_decode_ylen=8, dropout_dec_rate=0.0,
                 log_step=1)
    conf_path = tmp_path / "rnnt.yaml"
    conf_path.write_text(yaml.safe_dump(conf))
    state = loop.main(["-conf", str(conf_path), "--cpu"])
    assert state.step == 24 * 4 and state.skipped == 0
    log = (tmp_path / "rnnt" / "log" / "train.log").read_text()
    assert "epoch 24 dev WER (greedy)" in log
    losses = [float(line.split("loss_total: ")[1].split()[0]) for line in log.splitlines() if "loss_total: " in line]
    assert losses[-1] < 0.5 * losses[0]
    for beam in (0, 3):
        argv = ["-conf", str(conf_path), "-ep", "24", "--beam_width", str(beam)]
        out = port_cli.main(argv + ["--cpu", "--save_dir", "torch"])
        jax_cli.test_main(jax_cli.build_argparser().parse_args(argv + ["--save_dir", "jax"]))
        name = f"result_test_beam{beam}_len0.0_ctc0.0_lm0.00_ep24.tsv"
        res = tmp_path / "rnnt" / "results"
        got = pd.read_table(res / "torch" / name, comment="#")
        ref = pd.read_table(res / "jax" / name, comment="#")
        pd.testing.assert_frame_equal(got, ref)
        assert (res / "torch" / name).read_text().splitlines()[0] == (res / "jax" / name).read_text().splitlines()[0]
        assert out[3].startswith("WER:")
