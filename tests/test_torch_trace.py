"""The port's spans and counters (`emoasr_tpu_torch/utils/profile.py`), on
the CPU, on a tiny CTC model (1 layer, d=32, V=12) and corpus.

- With no profiler running, `span()` is the one shared no-op and a window
  of micro-steps records nothing.
- Under `torch.profiler` (CPU activity): a micro-step records
  `train.micro_step` with `train.forward` and `train.backward` as children,
  and `train.update` on the `accum_grad`-th, all with the micro-step's key;
  each span encloses its own events in the same profile (autograd's
  functions in `train.backward`, the forward's layer norms in
  `train.forward`, `Optimizer.step` in `train.update`) to within 1 ms: one
  clock.
- `prefetch_to_device`: `feed.wait` on the consumer, `feed.collate` on the
  producer thread with the batches' real and padded frames;
  `decode_dataset`: `decode.wait` and `decode.postproc` a batch;
  `rnnt_alpha_rowscan`: `rnnt.lattice`.
- The buffer drops beyond its bound and counts the drops; more threads
  than cores each keep their own stack of open spans, and every span is
  kept or counted as dropped.
- A micro-step's losses and updated parameters are bit-identical with and
  without a profiler running.
"""

import contextlib
import threading

import numpy as np
import pandas as pd
import pytest
import torch

from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.data.asr_dataset import ASRDataset
from emoasr_tpu_torch.eval.decode import build_decode_fn
from emoasr_tpu_torch.eval.test_asr import decode_dataset
from emoasr_tpu_torch.models.asr import ASR
from emoasr_tpu_torch.ops.rnnt import rnnt_alpha_rowscan
from emoasr_tpu_torch.train.loop import build_train_state, prefetch_to_device
from emoasr_tpu_torch.train.step import make_train_step
from emoasr_tpu_torch.utils import profile
from emoasr_tpu_torch.utils.vocab import Vocab

CPU = torch.device("cpu")
ACCUM = 2
MS = 1_000_000  # ns


def _corpus(tmp_path, n_utts=10, V=12, F=16):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n_utts):
        U = int(rng.integers(2, 5))
        T = int(rng.integers(U * 4, 30))
        x = rng.normal(size=(T, F)).astype(np.float32)
        p = tmp_path / f"u{i}.npy"
        np.save(p, x)
        toks = rng.integers(3, V, size=U)
        rows.append(dict(feat_path=str(p), utt_id=f"spk-u{i}-{i * 1000}-{i * 1000 + T * 10}",
                         token_id=" ".join(map(str, toks)), text=" ".join(f"w{t}" for t in toks), xlen=T, ylen=U))
    tsv = tmp_path / "train.tsv"
    pd.DataFrame(rows).to_csv(tsv, sep="\t", index=False)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["<blank> 0", "<unk> 1", "<eos> 2"] + [f"▁w{i} {i}" for i in range(3, V)]) + "\n",
                     encoding="utf-8")
    return str(tsv), str(vocab)


@pytest.fixture
def setup(tmp_path):
    tsv, vocab = _corpus(tmp_path)
    cfg = config_from_dict(dict(
        encoder_type="transformer", decoder_type="ctc", input_layer="linear", feat_dim=16,
        enc_hidden_size=32, enc_num_attention_heads=2, enc_num_layers=1, enc_intermediate_size=64,
        vocab_size=12, vocab_path=vocab, train_path=tsv, test_path=tsv, buckets=[[32, 8]],
        batch_size=4, max_xlens_batch=512, max_ylens_batch=64, learning_rate=5.0, lr_schedule_type="noam",
        num_warmup_steps=10, spec_augment=False, clip_grad_norm=5.0, accum_grad=ACCUM, seed=0))
    return cfg, tsv, vocab


def _batches(cfg, tsv):
    dataset = ASRDataset(cfg, tsv, phase="train")
    return list(prefetch_to_device(dataset.batches(dataset.make_batcher(seed=0)), CPU))


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def empty_recorder():
    profile.clear()
    yield
    profile.clear()


def test_no_profiler_no_records(setup):
    cfg, tsv, _ = setup
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profile.span("train.forward") is profile.span("feed.wait", key=3) is profile._OFF
    state, gen = build_train_state(cfg, CPU)
    step = make_train_step(cfg)
    batches = _batches(cfg, tsv)
    for batch in batches * 3:  # a window's worth: three updates
        step(state, batch, gen)
    assert state.step == 3 * len(batches) == 3 * ACCUM
    assert profile.records() == [] and profile.dropped() == 0


def _step_spans(cfg, tsv):
    state, gen = build_train_state(cfg, CPU)
    step = make_train_step(cfg)
    batches = _batches(cfg, tsv)[:ACCUM]
    with _profiler() as prof:
        for batch in batches:
            step(state, batch, gen)
    return profile.records(), prof


def test_micro_step_spans_and_their_keys(setup):
    recs, _ = _step_spans(*setup[:2])
    steps = {r.key: r for r in recs if r.name == "train.micro_step"}
    assert sorted(steps) == [1, 2] and all(r.parent is None for r in steps.values())
    for key, outer in steps.items():
        kids = sorted((r for r in recs if r.parent == outer.id), key=lambda r: r.start_ns)
        want = ["train.forward", "train.backward"] + (["train.update"] if key == ACCUM else [])
        assert [r.name for r in kids] == want
        for r in kids:
            assert r.key == key and r.thread == outer.thread == threading.get_native_id()
            assert outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns
    assert {r.name for r in recs} == {"train.micro_step", "train.forward", "train.backward", "train.update"}


@pytest.mark.parametrize("span,events", [
    ("train.forward", lambda n: n == "aten::native_layer_norm"),
    ("train.backward", lambda n: n.startswith("autograd::engine::evaluate_function")),
    ("train.update", lambda n: n.startswith("Optimizer.step#")),
])
def test_spans_enclose_their_events_on_the_profilers_clock(setup, span, events):
    recs, prof = _step_spans(*setup[:2])
    ranges = [(r.start_ns, r.end_ns) for r in recs if r.name == span]
    found = [e for e in prof.profiler.kineto_results.events() if events(e.name())]
    assert ranges and found
    for e in found:
        assert any(a - MS <= e.start_ns() and e.end_ns() <= b + MS for a, b in ranges), (e.name(), ranges)


def test_feed_spans_and_frame_counts(setup):
    cfg, tsv, _ = setup
    dataset = ASRDataset(cfg, tsv, phase="train")
    with _profiler():
        got = list(prefetch_to_device(dataset.batches(dataset.make_batcher(seed=0)), CPU))
    recs = profile.records()
    me = threading.get_native_id()
    waits = [r for r in recs if r.name == "feed.wait"]
    collates = [r for r in recs if r.name == "feed.collate"]
    assert len(waits) == len(got) + 1  # a batch each, then the end of the feed
    assert all(r.thread == me for r in waits)
    assert len(collates) == len(got) + 1 and all(r.thread != me for r in collates)
    host = list(dataset.batches(dataset.make_batcher(seed=0)))
    real = sum(int(b["xlens"][: b["n_valid"]].sum()) for b in host)
    padded = sum(b["xs"].shape[0] * b["xs"].shape[1] for b in host)
    assert sum(r.counts.get("frames.real", 0) for r in collates) == real
    assert sum(r.counts.get("frames.padded", 0) for r in collates) == padded > real


def test_decode_spans_a_batch(setup):
    cfg, tsv, vocab = setup
    torch.manual_seed(0)
    model = ASR(cfg).eval()
    dataset = ASRDataset(cfg, tsv, phase="test")
    n = len(list(dataset.make_batcher()))
    with _profiler():
        rows = decode_dataset(cfg, dataset, build_decode_fn(model, cfg, beam_width=0, device=CPU), Vocab(vocab))
    assert len(rows) == 10
    recs = profile.records()
    assert sorted(r.key for r in recs if r.name == "decode.postproc") == list(range(n))
    assert sorted(r.key for r in recs if r.name == "decode.wait") == list(range(n + 1))  # and the pass's end
    collates = [r for r in recs if r.name == "decode.collate"]
    assert sum(r.counts["frames.real"] for r in collates if r.counts) == sum(int(x) for x in pd.read_table(tsv)["xlen"])


def test_lattice_span():
    g = torch.Generator().manual_seed(0)
    lp_blank = torch.randn(2, 7, 4, generator=g).log_softmax(-1)
    lp_label = torch.randn(2, 7, 3, generator=g).log_softmax(-1)
    want = rnnt_alpha_rowscan(lp_blank, lp_label, torch.tensor([7, 5]), torch.tensor([3, 2]))
    with _profiler():
        got = rnnt_alpha_rowscan(lp_blank, lp_label, torch.tensor([7, 5]), torch.tensor([3, 2]))
    assert torch.equal(got, want)
    assert [r.name for r in profile.records()] == ["rnnt.lattice"]


def test_buffer_drops_beyond_its_bound(monkeypatch):
    monkeypatch.setattr(profile, "MAX_RECORDS", 3)
    with _profiler():
        for i in range(5):
            with profile.span("x", key=i):
                profile.count("n", i)
    recs = profile.records()
    assert [(r.key, r.counts) for r in recs] == [(0, {"n": 0}), (1, {"n": 1}), (2, {"n": 2})]
    assert profile.dropped() == 2
    profile.clear()
    assert profile.records() == [] and profile.dropped() == 0


def test_micro_steps_bit_identical_with_a_profiler(setup):
    cfg, tsv, _ = setup
    batches = _batches(cfg, tsv)[:ACCUM]

    def run(traced):
        state, gen = build_train_state(cfg, CPU)
        step = make_train_step(cfg)
        with _profiler() if traced else contextlib.nullcontext():
            losses = [step(state, b, gen)["loss_total"] for b in batches]
        return losses, [p.detach().clone() for p in state.model.parameters()]

    (l0, p0), (l1, p1) = run(False), run(True)
    assert profile.records()  # the traced run recorded
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert any(not torch.equal(a, b) for a, b in zip(p0, build_train_state(cfg, CPU)[0].model.parameters()))


def test_threads_record_their_own_stacks_and_lose_nothing(monkeypatch):
    """More threads than cores, a short switch interval: every span is kept
    or counted as dropped, and each child's parent is its own thread's."""
    import os
    import sys

    n_threads, per = 2 * (os.cpu_count() or 1) + 2, 200
    monkeypatch.setattr(profile, "MAX_RECORDS", n_threads * per * 3 // 4)  # a quarter are dropped

    def work(t):
        for i in range(per // 2):
            with profile.span("outer", key=t * per + i):
                with profile.span("inner"):
                    profile.count("n", 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiler():
            threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = profile.records()
    assert len(recs) == n_threads * per * 3 // 4 and len(recs) + profile.dropped() == n_threads * per
    outer = {r.id: r for r in recs if r.name == "outer"}
    for r in recs:
        if r.name == "inner":
            assert r.counts == {"n": 1}
            if r.parent in outer:
                assert outer[r.parent].thread == r.thread and outer[r.parent].key == r.key
