"""The port's train and eval CLIs on two ranks of `torchrun --standalone`
over gloo (`--cpu`), against one process and against the JAX eval CLI.

- `python -m torch.distributed.run --standalone --nproc_per_node 2 -m
  emoasr_tpu_torch.train.loop -conf <yaml> --cpu` on the overfit corpus of
  `tests/test_torch_train_cli.py` (B = 8, 4 + 4 a rank; dropout and
  SpecAugment on, a dev set, a checkpoint every 3 epochs, 6 epochs): the
  same logged losses and learning rates as one process, each line once
  (rank 0 alone writes and validates), the same `model.ep3` / `model.ep6`;
  the same
  on `mesh_shape: [1, 2]` (tensor parallelism: rank 0 validates a whole
  copy of the gathered shares).  The same for
  `train_lm` with BERT on `mesh_shape: [1, 2]` (tensor parallelism, dropout
  on), 2 epochs of 5 steps.
- The eval CLI with `--dp --cpu` on two ranks: the TSV of one process and of
  the JAX eval CLI on a single-bucket corpus (8 rows a batch, 4 + 4 a
  rank), on overfit (decisive) models: CTC with beam 4, and a Transformer
  decoder with beam 3 (`test_mesh_decode_matches_single_device`'s two
  decoders), joint CTC 0.3 (its attention-only beam stops early on this
  corpus: WER about 50).  The CTC model on a corpus of two buckets, of 4 rows a batch
  and of 3 (the tail that does not divide: rank 0 decodes it whole): the
  TSV of one process.

Tolerances: logged losses as printed (3 decimals) within 2e-3; the
checkpoints atol 1e-5 + rtol 1e-4, the key biases (true gradient 0, Adam
turns their noise into +-LR) within the sum of the LRs; TSVs exactly.
"""

import os
import re
import subprocess
import sys

import pandas as pd
import pytest
import torch
import yaml

from emoasr_tpu.eval import test_asr as jax_cli
from emoasr_tpu_torch.eval import test_asr as port_cli
from emoasr_tpu_torch.train import loop, train_lm
from emoasr_tpu_torch.train.checkpoint import load_state_dict
from test_e2e_overfit import _make_corpus
from test_torch_lm_train import _corpus as _lm_corpus
from test_torch_lm_train import _write_conf as _lm_conf
from test_torch_train_cli import _conf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _torchrun(module, argv, log):
    """Two ranks of `module` on the CPU, started in the background."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    out = open(log, "w")
    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                             "-m", module, *argv, "--cpu"], cwd=REPO, env=env, stdout=out,
                            stderr=subprocess.STDOUT), log


def _wait(run, timeout=240):
    proc, log = run
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    with open(log) as f:
        text = f.read()
    assert rc == 0, text[-6000:]
    return text


def _tsv(conf_path, sub, name):
    path = os.path.join(os.path.splitext(str(conf_path))[0], "results", sub, name)
    with open(path) as f:
        return f.read()


def _log_lines(conf_path):
    with open(os.path.join(os.path.splitext(str(conf_path))[0], "log", "train.log")) as f:
        return [re.sub(r"^.*?(INFO|WARNING|ERROR): ", "", line.rstrip()) for line in f]


def _numbers(line):
    return [float(x) for x in re.findall(r"-?\d+\.\d+", line)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two overfit models (CTC; Transformer decoder + CTC 0.3), trained in
    this process, and the training configurations."""
    tmp = tmp_path_factory.mktemp("cli")
    tsv, vocab = _make_corpus(tmp)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ctc = tmp / "ctc.yaml"  # one bucket of 8 rows a batch, as it trained
        ctc.write_text(yaml.safe_dump(_conf(tsv, vocab)))
        loop.main(["-conf", str(ctc), "--cpu"])
        tail = tmp / "tail.yaml"  # the same model decoded in two buckets: T <= 18 at 4 a batch, T <= 32 at 3
        tail.write_text(yaml.safe_dump(_conf(tsv, vocab, buckets=[[18, 8], [32, 8]], batch_size=4,
                                             max_xlens_batch=96)))
        os.makedirs(tmp / "tail" / "checkpoints")
        os.link(tmp / "ctc" / "checkpoints" / "model.ep60", tmp / "tail" / "checkpoints" / "model.ep60")
        att = tmp / "att.yaml"
        att.write_text(yaml.safe_dump(_conf(
            tsv, vocab, decoder_type="transformer", dec_hidden_size=32, dec_num_attention_heads=2,
            dec_num_layers=1, dec_intermediate_size=64, mtl_ctc_weight=0.3, lsm_prob=0.1, dropout_dec_rate=0.0,
            max_decode_ylen=8)))
        loop.main(["-conf", str(att), "--cpu"])
        short = dict(num_epochs=6, log_step=2, save_step=3, dev_path=tsv, dropout_enc_rate=0.1,
                     dropout_attn_rate=0.1, spec_augment=True, max_mask_freq=4, max_mask_time=4)
        one, two, tp = tmp / "one.yaml", tmp / "two.yaml", tmp / "tp.yaml"
        for p in (one, two):
            p.write_text(yaml.safe_dump(_conf(tsv, vocab, **short)))
        tp.write_text(yaml.safe_dump(_conf(tsv, vocab, mesh_shape=[1, 2], mesh_axes=["data", "model"], **short)))
        # BERT through train_lm on (1, 2): heads and FF columns split over the two ranks
        lm_tsv = _lm_corpus(tmp / "lm.tsv")
        bert = {name: _lm_conf(tmp / f"{name}.yaml", "bert", lm_tsv, num_epochs=2, save_step=2, log_step=1,
                               mesh_shape=[1, 2], mesh_axes=["data", "model"]) for name in ("bert_one", "bert_two")}
        yield dict(tmp=tmp, ctc=ctc, tail=tail, att=att, one=one, two=two, tp=tp, **bert)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(corpus):
    """The three two-rank runs, started together; the one-process and JAX
    runs meanwhile."""
    tmp = corpus["tmp"]
    ctc_argv = ["-conf", str(corpus["ctc"]), "-ep", "60", "--beam_width", "4"]
    tail_argv = ["-conf", str(corpus["tail"]), "-ep", "60", "--beam_width", "4"]
    att_argv = ["-conf", str(corpus["att"]), "-ep", "60", "--beam_width", "3", "--decode_ctc_weight", "0.3"]
    started = [
        _torchrun("emoasr_tpu_torch.train.loop", ["-conf", str(corpus["two"])], tmp / "train.log"),
        _torchrun("emoasr_tpu_torch.train.loop", ["-conf", str(corpus["tp"])], tmp / "tp.log"),
        _torchrun("emoasr_tpu_torch.train.train_lm", ["-conf", corpus["bert_two"]], tmp / "bert.log"),
        _torchrun("emoasr_tpu_torch.eval.test_asr", ctc_argv + ["--dp", "--save_dir", "dp"], tmp / "ctc.log"),
        _torchrun("emoasr_tpu_torch.eval.test_asr", tail_argv + ["--dp", "--save_dir", "dp"], tmp / "tail.log"),
        _torchrun("emoasr_tpu_torch.eval.test_asr", att_argv + ["--dp", "--save_dir", "dp"], tmp / "att.log"),
    ]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loop.main(["-conf", str(corpus["one"]), "--cpu"])
        train_lm.main(["-conf", corpus["bert_one"], "--cpu"])
        for argv in (ctc_argv, tail_argv, att_argv):
            port_cli.main(argv + ["--cpu", "--save_dir", "one"])
        # the JAX CLI on the single-bucket corpora (it pairs rows across
        # buckets of other sizes otherwise, ROADMAP.md section 3)
        for argv in (ctc_argv, att_argv):
            jax_cli.test_main(jax_cli.build_argparser().parse_args(argv + ["--save_dir", "jax"]))
    finally:
        torch.set_num_threads(threads)
    return [_wait(r) for r in started]


@pytest.mark.parametrize("run,mesh", [("two", "(2,) ('data',)"), ("tp", "(1, 2) ('data', 'model')")])
def test_two_rank_training_matches_one_process(corpus, runs, run, mesh):
    """(2,): each rank 4 of the 8 rows; (1, 2): each rank 1 of the 2 heads
    and 32 of the FF's 64 columns, validated by rank 0 on a whole copy of
    the gathered shares, the checkpoint gathered."""
    one, two = _log_lines(corpus["one"]), _log_lines(corpus[run])
    steps = [line for line in one if "loss_total" in line]
    assert len(steps) == 12 and len([line for line in two if "loss_total" in line]) == 12
    for a, b in zip(steps, [line for line in two if "loss_total" in line]):
        assert a.split("loss")[0] == b.split("loss")[0]  # "epoch N step i/4"
        for x, y in zip(_numbers(a.split("loss")[1]), _numbers(b.split("loss")[1])):
            assert abs(x - y) <= 2e-3, (a, b)
    for key in ("dev WER (greedy)", "checkpoint saved", " done in "):
        assert sum(key in line for line in two) == sum(key in line for line in one) > 0, key
    assert any(f"mesh {mesh}: rank 0 of 2" in line for line in two)
    assert not any("rank 1 of 2" in line for line in two)
    lrs = [float(line.split("lr: ")[1]) for line in steps]
    for ep in (3, 6):
        a = load_state_dict(str(corpus["tmp"] / "one" / "checkpoints" / f"model.ep{ep}"))
        b = load_state_dict(str(corpus["tmp"] / run / "checkpoints" / f"model.ep{ep}"))
        assert set(a) == set(b)
        for k in a:
            if k.endswith("linear_k.bias"):
                assert (a[k] - b[k]).abs().max() <= 4 * sum(lrs), k
                continue
            torch.testing.assert_close(b[k], a[k], atol=1e-5, rtol=1e-4, msg=k)
    assert os.path.exists(corpus["tmp"] / run / "checkpoints" / "optim.ep6")


def _wer(tsv):
    return float(re.search(r"WER: ([\d.]+)", tsv.splitlines()[0]).group(1))


def test_bert_tensor_parallel_train_lm_matches_one_process(corpus, runs):
    """`train_lm` under torchrun on `mesh_shape: [1, 2]` (BERT's query /
    key / value and intermediate column-parallel, its attention output and
    per-layer output row-parallel, dropout on): the logged losses and the
    checkpoint of one process."""
    one, two = _log_lines(corpus["bert_one"]), _log_lines(corpus["bert_two"])
    steps = [line for line in one if "loss_total" in line]
    assert len(steps) == 10 and len([line for line in two if "loss_total" in line]) == 10
    for a, b in zip(steps, [line for line in two if "loss_total" in line]):
        assert a.split("loss")[0] == b.split("loss")[0]
        for x, y in zip(_numbers(a.split("loss")[1]), _numbers(b.split("loss")[1])):
            assert abs(x - y) <= 2e-3, (a, b)
    assert any("mesh (1, 2) ('data', 'model'): rank 0 of 2" in line for line in two)
    lrs = [float(line.split("lr: ")[1]) for line in steps]
    a = load_state_dict(str(corpus["tmp"] / "bert_one" / "checkpoints" / "model.ep2"))
    b = load_state_dict(str(corpus["tmp"] / "bert_two" / "checkpoints" / "model.ep2"))
    assert set(a) == set(b)
    for k in a:
        if k.endswith("attention.self.key.bias"):
            assert (a[k] - b[k]).abs().max() <= 4 * sum(lrs), k
            continue
        torch.testing.assert_close(b[k], a[k], atol=1e-5, rtol=1e-4, msg=k)


@pytest.mark.parametrize("model,name", [
    ("ctc", "result_test_beam4_len0.0_ctc0.0_lm0.00_ep60.tsv"),
    ("att", "result_test_beam3_len0.0_ctc0.3_lm0.00_ep60.tsv"),
])
def test_dp_eval_writes_the_one_process_and_jax_tsv(corpus, runs, model, name):
    conf = corpus[model]
    dp, one, jax = (_tsv(conf, sub, name) for sub in ("dp", "one", "jax"))
    assert dp == one == jax
    rows = pd.read_table(os.path.join(os.path.splitext(str(conf))[0], "results", "dp", name), comment="#")
    assert len(rows) == 32 and _wer(dp) < 15.0, dp.splitlines()[0]


def test_the_tail_bucket_that_does_not_divide_is_decoded_whole(corpus, runs):
    """Two buckets, of 4 rows a batch (2 + 2 a rank) and of 3 (rank 0
    decodes them whole): the TSV of one process, every row in its order."""
    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.data.asr_dataset import ASRDataset

    cfg = load_config(str(corpus["tail"]))
    sizes = {b["xs"].shape[0] for b in ASRDataset(cfg, cfg.test_path, phase="test").batches()}
    assert sizes == {3, 4}
    name = "result_test_beam4_len0.0_ctc0.0_lm0.00_ep60.tsv"
    dp, one = _tsv(corpus["tail"], "dp", name), _tsv(corpus["tail"], "one", name)
    assert dp == one and _wer(dp) < 15.0
    assert len(pd.read_table(os.path.join(os.path.splitext(str(corpus["tail"]))[0], "results", "dp", name),
                             comment="#")) == 32
