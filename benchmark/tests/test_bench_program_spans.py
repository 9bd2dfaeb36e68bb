"""The readers of the program's own spans (`harness/program_spans.py` and
the metrics that use it) on a hand-built trace and span list: device time
launched from another thread, idle time inside a span, launch counts, host
time, pad share; nothing outside the traced stretch; None where the
program recorded no span."""

import time

import pytest
import torch

from emoasr_tpu_torch.utils import profile
from harness import program_spans, spec
from harness.trace import Event, Trace

NEW = {"forward_device_ms.train", "backward_device_ms.train", "update_device_ms.train", "feed_wait_ms.train",
       "step_idle_ms.train", "lattice_idle_ms.train", "launches.train", "pad_share.train",
       "collate_wait_ms.decode", "postproc_ms.decode", "pad_share.decode"}


def rec(name, a, b, counts=None, key=None, thread=1):
    return profile.Record(0, name, None, key, thread, int(round(a * 1e9)), int(round(b * 1e9)), counts or {})


def trace():
    host = [Event("cudaLaunchKernel", "cuda_runtime", 11.5, 11.501, 7, 2),  # autograd's thread, inside
            Event("cudaLaunchKernel", "cuda_runtime", 12.5, 12.501, 8, 1),  # outside the backward
            Event("cudaMemcpyAsync", "cuda_runtime", 11.2, 11.201, 9, 1),
            Event("cudaLaunchKernel", "cuda_runtime", 14.1, 14.101, 10, 1)]
    device = [Event("k_bwd", "kernel", 11.6, 11.9, 7, 0), Event("k_later", "kernel", 12.6, 13.5, 8, 0),
              Event("Memcpy HtoD", "memory", 11.3, 11.5, 9, 0), Event("k_upd", "kernel", 14.2, 14.4, 10, 0)]
    return Trace(10.0, 20.0, device, host)


SPANS = [
    rec("train.micro_step", 11.0, 13.0, key=1), rec("train.backward", 11.4, 12.0, key=1),
    rec("train.micro_step", 14.0, 15.0, key=2), rec("train.update", 14.05, 14.5, key=2),
    rec("feed.wait", 10.9, 11.0), rec("feed.wait", 13.9, 14.0),
    rec("feed.collate", 10.5, 10.6, {"frames.real": 60, "frames.padded": 100}, thread=3),
    rec("feed.collate", 12.5, 12.6, {"frames.real": 20, "frames.padded": 100}, thread=3),
    rec("feed.collate", 19.9, 20.5, {"frames.real": 100, "frames.padded": 100}, thread=3),  # ends after the stretch
    rec("train.micro_step", 9.0, 9.5, key=0),  # before it
]


@pytest.fixture
def ctx(monkeypatch):
    monkeypatch.setattr(program_spans, "records", lambda: list(SPANS))
    return {"trace": trace()}


def read(name, ctx):
    return spec.metric_reader(name).read(ctx)


def test_device_time_from_another_threads_launch(ctx):
    assert read("backward_device_ms.train", ctx) == pytest.approx(300.0)  # k_bwd; not the copy, not k_later
    assert read("update_device_ms.train", ctx) == pytest.approx(200.0)
    assert read("forward_device_ms.train", ctx) is None  # no such span


def test_launches_and_idle_inside_the_micro_steps(ctx):
    assert read("launches.train", ctx) == pytest.approx((2 + 1) / 2)  # k_bwd, k_later; k_upd
    # busy in [11, 13]: the copy 0.2, k_bwd 0.3, k_later 0.4; in [14, 15]: k_upd 0.2
    assert read("step_idle_ms.train", ctx) == pytest.approx(1e3 * ((2.0 - 0.9) + (1.0 - 0.2)) / 2)
    assert read("lattice_idle_ms.train", ctx) is None


def test_host_time_and_pad_share(ctx):
    assert read("feed_wait_ms.train", ctx) == pytest.approx(100.0)
    assert read("pad_share.train", ctx) == pytest.approx(100.0 * (1 - 80 / 200))  # the third ends outside


def test_decode_readers_per_batch(monkeypatch):
    spans = [rec("decode.wait", 11.0, 11.03, key=0), rec("decode.postproc", 11.5, 11.505, key=0),
             rec("decode.wait", 12.0, 12.001, key=1), rec("decode.postproc", 12.5, 12.507, key=1),
             rec("decode.wait", 12.6, 12.609, key=2),  # the pass's end
             rec("decode.collate", 11.0, 11.1, {"frames.real": 30, "frames.padded": 40}, thread=3)]
    monkeypatch.setattr(program_spans, "records", lambda: spans)
    ctx = {"trace": trace()}
    assert read("collate_wait_ms.decode", ctx) == pytest.approx((30 + 1 + 9) / 2)
    assert read("postproc_ms.decode", ctx) == pytest.approx(6.0)
    assert read("pad_share.decode", ctx) == pytest.approx(25.0)


@pytest.mark.parametrize("name", sorted(NEW))
def test_none_without_spans_or_trace(name, monkeypatch):
    monkeypatch.setattr(program_spans, "records", lambda: [])
    assert read(name, {"trace": trace()}) is None
    monkeypatch.setattr(program_spans, "records", lambda: list(SPANS))
    assert read(name, {"trace": None}) is None


def test_entries_match_their_files():
    entries = {m["name"]: m for m in spec.load_json(f"{spec.ROOT}/BENCHMARK.json")["per_layer"]}
    assert NEW <= set(entries)
    for name in NEW:
        mod = spec.metric_reader(name)
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == tuple(entries[name][k] for k in ("unit", "layer", "moves"))


def test_program_spans_land_on_the_trace_clock():
    profile.clear()
    a = time.time_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profile.span("feed.wait"):
            time.sleep(0.002)
    b = time.time_ns()
    try:
        got = program_spans.spans({"trace": Trace(a * 1e-9, b * 1e-9)}, "feed.wait")
        assert len(got) == 1 and got[0].end_ns - got[0].start_ns >= 2_000_000
        assert program_spans.spans({"trace": Trace(b * 1e-9, b * 1e-9 + 1)}, "feed.wait") == []
    finally:
        profile.clear()
