"""The port's fbank front end and corpus-prep CLI against the JAX package's,
on the CPU.

- `mel_banks` equal to the JAX banks within 1e-6, the hamming window and
  `num_frames` exact.
- `log_mel_fbank` against the independent float64 kaldi implementation of
  tests/test_frontend_golden.py within 1e-4 (the port computes in float64;
  that file holds the JAX fbank to 3e-4), and against the JAX fbank on
  random int16-scaled signals, a speech-like sweep and a batch of lengths
  within that 3e-4 (the JAX fbank's float32 error is the difference:
  1.1e-4 at most here); frame counts exact, zeros past each length.
- `load_wav` equal to the JAX reader (mono and the first of two channels).
- Every prep subcommand that needs neither `sentencepiece`, `pyopenjtalk`
  nor a network, through both CLIs on copies of one synthetic corpus
  (talk wavs and stm files, EuroParl-style json sessions, a lexicon):
  `make_utts_stm` (with segment extension), `make_utts_json`,
  `join_suffix`, `wav_to_feats` (`--cpu`), `norm_feats`, `prep_tsv`,
  `sort_bylen` (ASR and P2W), `split_tsv` (with and without shuffling),
  `concat_text`, `get_cols`, `rm_utt`, `map2phone`.  TSVs equal once the
  copies' directories are named alike, wavs bit-equal, features within
  1e-4 of the float64 kaldi implementation and within 1e-3 of the JAX
  CLI's (the JAX fbank's float32 error reaches 5.5e-4 on these tones,
  above its own 3e-4: ROADMAP.md §3), the CMVN statistics within rtol
  1e-5, and the normalized features
  equal bit for bit to the JAX `norm_feats` arithmetic on the port's own
  features and statistics (the standard deviation comes from float32 sums
  of squares, E[x^2] - mean^2: its cancellation turns the features' 1e-7
  relative differences into 3e-4 relative ones).
- The gated subcommands (`spm_train`, `spm_encode`, `map2phone_g2p`)
  raise the JAX package's messages where their packages are missing.
"""

import filecmp
import json
import os
import pickle
import shutil
import sys
import wave

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from emoasr_tpu.corpora import prep as jax_prep
from emoasr_tpu.frontend import fbank as jax_fbank
from emoasr_tpu_torch.corpora import prep
from emoasr_tpu_torch.frontend import fbank
from test_frontend_golden import _hf_fbank

FEAT_TOL = 3e-4  # the JAX fbank's bound against the float64 kaldi implementation


def _signal(seed, n):
    return np.random.default_rng(seed).integers(-(2 ** 14), 2 ** 14, n).astype(np.float32)


def _speechlike(seed=3, n=32000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    wav = 0.3 * np.sin(2 * np.pi * (200 + 150 * t) * t) + 0.01 * rng.normal(size=t.shape)
    return (np.clip(wav, -1, 1) * 2 ** 15).astype(np.float32)


def test_mel_banks_window_and_frame_count_match_jax():
    for bins in (80, 40):
        np.testing.assert_allclose(fbank.mel_banks(bins), jax_fbank.mel_banks(bins), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(fbank._hamming(400), jax_fbank._hamming(400))
    n = np.array([0, 399, 400, 559, 560, 16000, 123457])
    np.testing.assert_array_equal(fbank.num_frames(torch.from_numpy(n)).numpy(), np.asarray(jax_fbank.num_frames(n)))


@pytest.mark.parametrize("wav", [_signal(0, 16000), _signal(1, 7777), _signal(2, 400), _speechlike()],
                         ids=["1s", "odd", "one_frame", "sweep"])
def test_log_mel_fbank_matches_jax_and_the_kaldi_golden(wav):
    want, wlens = jax_fbank.log_mel_fbank(jnp.asarray(wav)[None])
    got, flens = fbank.log_mel_fbank(torch.from_numpy(wav)[None])
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(flens.numpy(), np.asarray(wlens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FEAT_TOL)
    np.testing.assert_allclose(got[0, :int(flens[0])].numpy(), _hf_fbank(wav), rtol=0, atol=1e-4)


def test_batched_log_mel_fbank_matches_jax_and_masks_past_each_length():
    rng = np.random.default_rng(4)
    wavs = rng.integers(-3000, 3000, (3, 16000)).astype(np.float32)
    lens = np.array([16000, 8000, 300], np.int32)
    want, wlens = jax_fbank.log_mel_fbank(jnp.asarray(wavs), jnp.asarray(lens), num_bins=40, max_frames=100)
    got, flens = fbank.log_mel_fbank(torch.from_numpy(wavs), torch.from_numpy(lens), num_bins=40, max_frames=100)
    assert flens.tolist() == [98, 48, 0] == np.asarray(wlens).tolist()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FEAT_TOL)
    assert not got[1, 48:].any() and not got[2].any()
    short, _ = fbank.log_mel_fbank(torch.from_numpy(wavs[1, :8000]), num_bins=40)
    np.testing.assert_allclose(got[1, :48].numpy(), short[0].numpy(), rtol=0, atol=FEAT_TOL)


def _write_wav(path, seconds, freq, seed, channels=1, rate=16000):
    t = np.arange(int(seconds * rate)) / rate
    rng = np.random.default_rng(seed)
    pcm = (np.sin(2 * np.pi * freq * t) * 8000 + rng.normal(size=t.shape) * 300).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.repeat(pcm[:, None], channels, 1).tobytes() if channels > 1 else pcm.tobytes())


def test_load_wav_matches_jax(tmp_path):
    for ch in (1, 2):
        p = tmp_path / f"c{ch}.wav"
        _write_wav(p, 0.3, 300, seed=ch, channels=ch)
        got, want = fbank.load_wav(str(p)), jax_fbank.load_wav(str(p))
        assert got.dtype == np.float32 and len(got) == 4800
        np.testing.assert_array_equal(got, want)


def _corpus(root):
    """Talk wavs + stm files, json sessions, a lexicon and a phone vocab."""
    wav_dir, stm_dir = root / "talks", root / "stm"
    wav_dir.mkdir()
    stm_dir.mkdir()
    for i, talk in enumerate(["TalkA", "TalkB"]):
        _write_wav(wav_dir / f"{talk}.wav", 4.0, 300 + 120 * i, seed=i)
        (stm_dir / f"{talk}.stm").write_text(
            f"{talk} 1 spk 0.30 1.50 <o,f0,male> hello it 's a test\n"
            f"{talk} 1 spk 1.80 3.20 <o,f0,male> ignore_time_segment_in_scoring\n"
            f"{talk} 1 spk 2.00 3.80 <o,f0,male> more words here\n"
            f"{talk} 1 spk 0.05 0.90 <o,f0,male> a short one\n")
    sess = root / "ep" / "t1" / "2020" / "s01"
    sess.mkdir(parents=True)
    _write_wav(sess / "ep-asr.en.orig.s01.wav", 3.0, 500, seed=9)
    (sess / "s01.json").write_text(json.dumps([
        {"b": 0.2, "e": 1.4, "wl": [{"w": "good"}, {"w": "morning"}]},
        {"b": 1.5, "e": 2.9, "wl": [{"w": "thank"}, {"w": "you"}, {"w": "all"}]},
    ]))
    (root / "lexicon.txt").write_text("hello HH AH L OW\nit IH T\ntest T EH S T\nmore M AO R\nwords W ER D Z\n"
                                      "here HH IY R\na AH\nshort SH AO R T\none W AH N\n")
    phones = ["<blank>", "<unk>", "<eos>", "NSN", "HH", "AH", "L", "OW", "IH", "T", "EH", "S", "M", "AO", "R", "W",
              "ER", "D", "Z", "IY", "SH", "N"]
    (root / "phones.txt").write_text("".join(f"{p} {i}\n" for i, p in enumerate(phones)))


def _run_jax_cli(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["prep"] + argv)
    jax_prep.main()


def _pipeline(run, d, root, cpu):
    """Every offline subcommand, in a pipeline's order, on directory `d`."""
    s = str
    run(["make_utts_stm", s(root / "stm"), s(root / "talks"), s(d / "wavs"), s(d / "utts.tsv"), "--extend_time"])
    run(["make_utts_json", s(root / "ep"), s(d / "wavs_ep"), s(d / "ep.tsv")])
    run(["join_suffix", s(d / "utts.tsv")])
    run(["rm_utt", s(d / "utts.tsv")])
    shutil.move(d / "utts_rm.tsv", d / "utts.tsv")
    run(["wav_to_feats", s(d / "utts.tsv")] + (["--cpu"] if cpu else []))
    run(["norm_feats", s(d / "utts.tsv"), s(d / "utts_norm.pkl")])
    df = pd.read_table(d / "utts.tsv")
    df["token_id"] = [" ".join(str(3 + (len(w) * 7 + i) % 20) for i, w in enumerate(t.split())) for t in df["text"]]
    df.to_csv(d / "utts.tsv", sep="\t", index=False)
    run(["prep_tsv", s(d / "utts.tsv")])
    run(["sort_bylen", s(d / "utts.tsv")])
    run(["split_tsv", s(d / "utts_sorted.tsv"), "-n_splits", "2"])
    run(["split_tsv", s(d / "ep.tsv"), "-n_splits", "2", "--shuffle"])
    run(["concat_text", s(d / "utts_sorted.tsv"), "--max_len", "6"])
    run(["get_cols", s(d / "utts_sorted.tsv"), "-cols", "utt_id", "text", "-out", s(d / "cols.txt"), "--no_header"])
    run(["rm_utt", s(d / "utts_sorted.tsv"), "-utt_ids", df["utt_id"][0], "-texts", "more words here"])
    run(["map2phone", s(d / "utts_sorted.tsv"), "-lexicon", s(root / "lexicon.txt"), "-vocab", s(root / "phones.txt")])
    run(["sort_bylen", s(d / "utts_sorted_p2w.tsv"), "--task", "P2W"])


def test_prep_subcommands_match_the_jax_cli(tmp_path, monkeypatch, capsys):
    _corpus(tmp_path)
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
    _pipeline(lambda argv: _run_jax_cli(monkeypatch, argv), tmp_path / "jax", tmp_path, cpu=False)
    _pipeline(prep.main, tmp_path / "torch", tmp_path, cpu=True)
    jd, td = tmp_path / "jax", tmp_path / "torch"
    files = sorted(os.path.relpath(os.path.join(r, f), jd) for r, _, fs in os.walk(jd) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), td) for r, _, fs in os.walk(td) for f in fs)
    kinds = {os.path.splitext(f)[1] for f in files}
    assert {".tsv", ".txt", ".wav", ".npy", ".pkl"} <= kinds
    with open(td / "utts_norm.pkl", "rb") as fp:
        st = pickle.load(fp)
    mean = st["lmfb_sum"] / st["num_frames"]  # emoasr_tpu/corpora/prep.py::norm_feats, term for term
    std = np.sqrt(np.maximum(st["lmfb_sqsum"] / st["num_frames"] - mean * mean, 1e-8))
    n_npy = 0
    for f in files:
        a, b = jd / f, td / f
        if f.endswith(".wav"):
            assert filecmp.cmp(a, b, shallow=False), f
        elif f.endswith(".npy"):
            if f.endswith("_norm.npy"):
                raw = np.load(str(b).replace("_norm.npy", ".npy"))
                np.testing.assert_array_equal(np.load(b), (raw - mean) / std, err_msg=f)
            else:
                got = np.load(b)
                np.testing.assert_allclose(got, _hf_fbank(fbank.load_wav(str(b)[:-4] + ".wav")), rtol=0, atol=1e-4,
                                           err_msg=f)
                np.testing.assert_allclose(got, np.load(a), rtol=0, atol=1e-3, err_msg=f)
            n_npy += 1
        elif f.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                pa, pb = pickle.load(fa), pickle.load(fb)
            assert pa["num_frames"] == pb["num_frames"] > 0
            for k in ("lmfb_sum", "lmfb_sqsum"):
                np.testing.assert_allclose(pb[k], pa[k], rtol=1e-5, err_msg=k)
        else:
            assert b.read_text().replace(str(td), str(jd)) == a.read_text(), f
    assert n_npy == 2 * len(pd.read_table(td / "utts.tsv")) == 2 * 6  # features and normalized features
    # the manifests point the port's features at the port's files
    assert all(p.startswith(str(td)) for p in pd.read_table(td / "utts.tsv")["feat_path"])


@pytest.mark.parametrize("argv,package", [
    (["spm_train", "text.txt", "-model_prefix", "m", "-vocab_size", "10"], "sentencepiece"),
    (["spm_encode", "x.tsv", "-model", "m.model"], "sentencepiece"),
    (["map2phone_g2p", "x.tsv", "-vocab", "v.txt"], "pyopenjtalk"),
])
def test_gated_subcommands_raise_the_jax_messages(argv, package, monkeypatch):
    with pytest.raises(RuntimeError) as got:
        prep.main(argv)
    with pytest.raises(RuntimeError) as want:
        _run_jax_cli(monkeypatch, argv)
    assert str(got.value) == str(want.value) and package in str(got.value)
