"""The last flags of the JAX CLIs, on the CPU: `--profile` of the train and
eval CLIs (`utils/profile.py`) and `fusion_grid --dp`.

- The train CLI with `--profile DIR` on the overfit corpus of
  `tests/test_torch_train_cli.py`: a first epoch of 16 batches is traced
  over batches 8-12 (five optimizer steps in the trace), one of 10 batches
  from batch 8 to the epoch's end (two), and the Chrome trace names aten
  operators and the program's spans (`train.update` once an optimizer
  step, `train.forward`, `train.backward`, `feed.wait`, ...).
- The eval CLI with `--profile DIR`: a trace of `decode_dataset` that names
  aten operators and the decoding loop's spans.
- `fusion_grid --dp` under a two-rank `torchrun` over gloo (each rank 3 of
  a batch's 6 rows): the grid's log lines, its best point and every point's
  TSV equal the one-process grid's.
"""

import json
import os
import re
import subprocess
import sys

import pytest
import yaml

from emoasr_tpu_torch.eval import test_asr as port_cli
from emoasr_tpu_torch.train import loop
from test_e2e_overfit import _make_corpus
from test_torch_kd_tools import _asr_setup, _write_lm
from test_torch_parallel_cli import REPO, _torchrun, _wait
from test_torch_train_cli import _conf


def _events(path):
    with open(path) as f:
        return [e.get("name", "") for e in json.load(f)["traceEvents"]]


@pytest.mark.parametrize("batch_size,steps", [(2, 5), (3, 2)])
def test_train_cli_profile_traces_the_first_epochs_batches_8_to_12(tmp_path, batch_size, steps):
    tsv, vocab = _make_corpus(tmp_path)
    conf = tmp_path / "prof.yaml"
    conf.write_text(yaml.safe_dump(_conf(tsv, vocab, batch_size=batch_size, num_epochs=1, save_step=1)))
    out = tmp_path / "trace"
    loop.main(["-conf", str(conf), "--cpu", "--profile", str(out)])
    names = _events(out / "train_steps.pt.trace.json")
    assert any(n.startswith("aten::") for n in names)
    assert sum(n.startswith("Optimizer.step#") for n in names) == steps
    assert sum(n == "train.update" for n in names) == steps
    assert {"train.micro_step", "train.forward", "train.backward", "feed.wait"} <= set(names)
    port_cli._SETUP_CACHE.clear()
    port_cli.main(["-conf", str(conf), "-ep", "1", "--beam_width", "0", "--cpu", "--profile", str(out)])
    names = _events(out / "decode_dataset.pt.trace.json")
    assert any(n.startswith("aten::") for n in names)
    assert {"decode.wait", "decode.postproc"} <= set(names)


def _grid_lines(text):
    return [re.sub(r"^.*?INFO: ", "", line) for line in text.splitlines()
            if "INFO: " in line and ("lm_weight:" in line or "best WER" in line)]


def test_fusion_grid_dp_on_two_ranks_matches_one_process(tmp_path):
    conf, _, V = _asr_setup(tmp_path)
    lm_conf = dict(lm_type="rnn", vocab_size=V, embedding_size=8, hidden_size=12, num_layers=1, dropout_rate=0.0)
    lm_conf_path, _ = _write_lm(tmp_path, "lm", lm_conf, seed=2)
    grid = ["-conf", conf, "-ep", "1", "--beam_width", "3", "--lm_conf", lm_conf_path, "--lm_ep", "1",
            "--lm_min", "0", "--lm_max", "0.5", "--lm_step", "0.5", "--len_min", "0", "--len_max", "1"]
    two = _torchrun("emoasr_tpu_torch.eval.fusion_grid", grid + ["--dp", "--save_dir", "dp"], tmp_path / "dp.log")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    one = subprocess.run([sys.executable, "-m", "emoasr_tpu_torch.eval.fusion_grid", *grid, "--cpu",
                          "--save_dir", "one"], cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert one.returncode == 0, one.stderr[-6000:]
    want, got = _grid_lines(one.stderr), _grid_lines(_wait(two))
    assert len(want) == 6 and got == want  # four points, the header, the best point
    res = os.path.join(os.path.splitext(conf)[0], "results")
    names = sorted(os.listdir(os.path.join(res, "one")))
    assert len(names) == 4 and sorted(os.listdir(os.path.join(res, "dp"))) == names
    for name in names:
        with open(os.path.join(res, "one", name)) as a, open(os.path.join(res, "dp", name)) as b:
            assert a.read() == b.read(), name
