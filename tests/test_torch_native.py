"""The port's native host components (`emoasr_tpu_torch/native`): the
edit distance and the .npy batch loader against their plain Python
versions and the JAX package, on the CPU.

- `edit_distance_native` against the Python DP of `eval/wer.py::
  compute_wer` on random pairs and on pairs built so that a substitution,
  an insertion and a deletion tie (the reference's backtrace priority
  C > I > S > D decides the breakdown): S, I, D and N equal; an empty
  hypothesis is all deletions.
- `compute_wers` by the native path equal to its Python path
  (`native=False`) and to the JAX package's `compute_wers`, words and
  characters, with empty hypotheses (`<dummy>`).
- `load_feat_batch_native` bit-equal to `np.load` (float32, float64, files
  wider than the columns asked for, rows past the batch's length cut); a
  missing file or another dtype raises `IOError`.
- `ASRDataset`'s collate by the native loader bit-equal to its `np.load`
  path, every batch of a two-bucket corpus.
- Four processes building the library into one empty directory at once
  all load it, and leave no temporary file; a failed build raises with
  g++'s output.
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from emoasr_tpu.eval.wer import compute_wers as jax_compute_wers
from emoasr_tpu_torch import native
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.data.asr_dataset import ASRDataset
from emoasr_tpu_torch.eval.wer import compute_wer, compute_wers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pairs(seed, n=200, V=6):
    rng = np.random.default_rng(seed)
    refs = [rng.integers(0, V, size=int(rng.integers(2, 12))).tolist() for _ in range(n)]
    hyps = [rng.integers(0, V, size=int(rng.integers(1, 12))).tolist() for _ in range(n)]
    # ties between S, I and D: one edit away in each direction
    hyps[:3] = [refs[0][:-1] + [V], refs[1] + [V], refs[2][1:]]
    hyps[3], refs[3] = [1, 2], [2, 1]
    hyps[4], refs[4] = [1, 1, 2], [1, 2, 2]
    return hyps, refs


def test_edit_distance_matches_the_python_dp():
    hyps, refs = _pairs(0)
    counts = native.edit_distance_native(hyps, refs)
    for (h, r), c in zip(zip(hyps, refs), counts):
        _, wd = compute_wer(h, r)
        assert c.tolist() == [wd["n_sub"], wd["n_ins"], wd["n_del"], wd["n_ref"]], (h, r)
    np.testing.assert_array_equal(native.edit_distance_native([[], [3]], [[1, 2, 3], [3]], num_threads=1),
                                  [[0, 0, 3, 3], [0, 0, 0, 1]])


@pytest.mark.parametrize("cer", [False, True])
def test_compute_wers_native_equals_python_and_jax(cer):
    hyps, refs = _pairs(1, n=60, V=5)
    words = lambda seqs: [[f"w{t}" for t in s] for s in seqs]
    hyps, refs = words(hyps), words(refs)
    hyps[5] = hyps[17] = []  # scored as "<dummy>"
    got = compute_wers(hyps, refs, cer=cer)
    assert got == compute_wers(hyps, refs, cer=cer, native=False)
    want = jax_compute_wers(hyps, refs, cer=cer)
    assert got[0] == pytest.approx(want[0], rel=1e-12) and got[1] == want[1]


def test_loader_matches_np_load(tmp_path):
    rng = np.random.default_rng(2)
    arrays = [rng.normal(size=(7, 8)).astype(np.float32), rng.normal(size=(12, 8)),  # float64
              rng.normal(size=(5, 11)).astype(np.float32), rng.normal(size=(30, 8)).astype(np.float32)]
    paths = []
    for i, a in enumerate(arrays):
        paths.append(str(tmp_path / f"x{i}.npy"))
        np.save(paths[-1], a)
    out, lens = native.load_feat_batch_native(paths, max_rows=20, cols=8)
    assert out.dtype == np.float32 and out.shape == (4, 20, 8)
    assert lens.tolist() == [7, 12, 5, 20]
    for i, a in enumerate(arrays):
        n = min(len(a), 20)
        np.testing.assert_array_equal(out[i, :n], np.load(paths[i])[:n, :8].astype(np.float32))
        assert not out[i, n:].any()
    np.save(tmp_path / "ints.npy", np.zeros((3, 8), np.int32))
    for bad in (str(tmp_path / "nope.npy"), str(tmp_path / "ints.npy")):
        with pytest.raises(IOError, match="native loader failed"):
            native.load_feat_batch_native([paths[0], bad], 10, 8)


def test_dataset_collate_native_equals_np_load(tmp_path):
    rng = np.random.default_rng(3)
    rows = []
    for i in range(11):
        T = int(rng.integers(5, 60))
        p = str(tmp_path / f"u{i}.npy")
        np.save(p, rng.normal(size=(T, 12)).astype(np.float32 if i % 3 else np.float64))
        rows.append(dict(feat_path=p, utt_id=f"u{i}", token_id="3 4 5", text="a b c", xlen=T, ylen=3))
    tsv = str(tmp_path / "x.tsv")
    pd.DataFrame(rows).to_csv(tsv, sep="\t", index=False)
    cfg = config_from_dict(dict(feat_dim=10, decoder_type="las", buckets=[[32, 8], [64, 8]], batch_size=4,
                                max_xlens_batch=256, max_ylens_batch=16))
    got = list(ASRDataset(cfg, tsv, "test").batches())
    want = list(ASRDataset(cfg, tsv, "test", native_loader=False).batches())
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(g[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


_BUILD = r"""
import sys
from emoasr_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
path = native.build()
lib = native._load()
print(path, native.edit_distance_native([[1, 2]], [[1, 3]]).tolist())
"""


def test_processes_build_the_library_at_once(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    lines = {o[0].strip() for o in outs}
    assert len(lines) == 1 and lines.pop().endswith("[[1, 0, 0, 2]]")
    assert [f for f in os.listdir(tmp_path) if not f.endswith(".so")] == []
    assert len(os.listdir(tmp_path)) == 1


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-DEMO_BROKEN", "-include", "no_such_header.h"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed(.|\n)*no_such_header"):
        native.build()
    assert os.listdir(tmp_path) == []
