"""The program's profiling: the CLIs' `--profile DIR` window and the spans
and counters that the port records while a profiler runs.

`Trace` is the CLIs' window (the JAX package's `jax.profiler` windows,
`train/loop.py:233-242` and `eval/test_asr.py:561-570`): a
`torch.profiler` trace of the host (and of the card's kernels, CUDA
activity, on the card), written as a Chrome trace
`DIR/<name>.pt.trace.json` (chrome://tracing, Perfetto, TensorBoard's
PyTorch plugin).  Under torchrun only rank 0 traces.

`span(name, key=None)` times a block of the program and `count(name, n)`
adds to the innermost open span of the calling thread.  They record
exactly while a `torch.profiler` records in this process, whatever its
activities (the flag that the profiler's start sets): inside a `Trace`
window, and under a profiler that another program (a benchmark) runs
around the port's calls.  Otherwise `span` reads that flag and returns one
shared no-op context: no clock, no allocation, no lock.  A record holds
the span's name, the id of the span that enclosed it on the same thread
(its parent), its key (the micro-step or batch number; a span without one
takes its parent's), the thread's native id, its start and end in
nanoseconds on the profiler's clock (Kineto's: Unix-epoch ns, so a span
lands on the trace's timeline with no offset to guess) and its counts.
Spans are stamped on `time.perf_counter_ns` and moved to that clock by one
`(time.time_ns(), perf_counter_ns())` pair taken when the recording
starts (the first span after `clear`).  Records stay in memory, at most
`MAX_RECORDS`; beyond it they are dropped and counted (`dropped`).  Inside
a `Trace` window each span also opens a `record_function` range, so the
Chrome trace shows the spans of the thread that started it (not the
collate threads'); `Trace.stop` clears the records.

Spans and counters of the port (their readers: `benchmark/metrics/`):

- `train.micro_step` (key: the micro-step number, 1 on), its children
  `train.forward`, `train.backward`, `train.update` (`train/step.py`);
  `rnnt.lattice` (`ops/rnnt.py::rnnt_alpha_rowscan`);
- `feed.wait` (the consumer) and `feed.collate` (the producer thread) in
  `train/loop.py::prefetch_to_device`;
- `decode.wait`, `decode.postproc` (key: the batch number in the pass, 0
  on) and `decode.collate` (the collate thread) in
  `eval/test_asr.py::decode_dataset`;
- the counts `frames.real` and `frames.padded` of every collated batch
  (`data/asr_dataset.py::ASRDataset.collate`), in the enclosing
  `feed.collate` or `decode.collate`.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

TRAIN_FIRST, TRAIN_LAST = 8, 12  # the train CLI's window: batches 8..12 of the first epoch
MAX_RECORDS = 1_000_000  # spans kept in memory; later ones are dropped and counted


class Record(NamedTuple):
    id: int
    name: str
    parent: Optional[int]  # the id of the enclosing span on the same thread
    key: Optional[int]
    thread: int  # the thread's native id
    start_ns: int  # on the profiler's clock (Unix-epoch ns)
    end_ns: int
    counts: Dict[str, int]


class _Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.records: List[Record] = []
        self.dropped = 0
        self.offset: Optional[int] = None  # time_ns - perf_counter_ns at the recording's start
        self.generation = 0  # bumped by `clear`: a span open across it is not kept
        self.annotate = False  # inside a `Trace` window: spans open `record_function` ranges
        self.ids = itertools.count()
        self.local = threading.local()

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def clock(self) -> int:
        with self.lock:
            if self.offset is None:
                self.offset = time.time_ns() - time.perf_counter_ns()
            return self.offset

    def add(self, rec: Record, generation: int) -> None:
        with self.lock:
            if generation != self.generation:
                return
            if len(self.records) < MAX_RECORDS:
                self.records.append(rec)
            else:
                self.dropped += 1

    def clear(self) -> None:
        with self.lock:
            self.records = []
            self.dropped = 0
            self.offset = None
            self.generation += 1


_REC = _Recorder()
_OFF = nullcontext()


class _Span:
    __slots__ = ("name", "key", "id", "parent", "counts", "offset", "generation", "fn", "start")

    def __init__(self, name: str, key: Optional[int]):
        self.name, self.key = name, key

    def __enter__(self):
        stack = _REC.stack()
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer is not None else None
        if self.key is None and outer is not None:
            self.key = outer.key
        self.id = next(_REC.ids)
        self.counts: Dict[str, int] = {}
        self.generation = _REC.generation
        self.offset = _REC.clock()
        self.fn = None
        if _REC.annotate:
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _REC.stack().pop()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        _REC.add(Record(self.id, self.name, self.parent, self.key, threading.get_native_id(),
                        self.start + self.offset, end + self.offset, self.counts), self.generation)
        return False


def span(name: str, key: Optional[int] = None):
    """A context that records the block as the span `name` while a
    profiler records (see the module note), else a shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, key)


def count(name: str, n: int) -> None:
    """Add `n` to the count `name` of the calling thread's innermost open
    span (nothing when no profiler records or no span is open)."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = _REC.stack()
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + int(n)


def records() -> List[Record]:
    """The spans recorded since the last `clear`, in the order they ended."""
    with _REC.lock:
        return list(_REC.records)


def dropped() -> int:
    """Spans dropped since the last `clear` (beyond `MAX_RECORDS`)."""
    return _REC.dropped


def clear() -> None:
    """Empty the records and the drop count; the next span takes a new clock
    pair, and a span open now is not kept."""
    _REC.clear()


class Trace:
    """One profiler window on `device`, started by `start` and written by
    `stop` once the device's work is done."""

    def __init__(self, out_dir: str, name: str, device: torch.device):
        self.path = os.path.join(out_dir, f"{name}.pt.trace.json")
        self.device = device
        self._prof = None

    def start(self) -> "Trace":
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        clear()
        _REC.annotate = True
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        return self

    def stop(self) -> str:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.__exit__(None, None, None)
        _REC.annotate = False
        clear()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        logging.info(f"profiler trace written to {self.path}")
        return self.path


@contextmanager
def trace(out_dir: str, name: str, device: torch.device):
    """A profiler window around the block."""
    t = Trace(out_dir, name, device).start()
    try:
        yield t
    finally:
        t.stop()
