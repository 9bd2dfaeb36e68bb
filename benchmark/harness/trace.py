"""The traced stretch of a window: `torch.profiler` over whole steps, its
events kept in memory and reduced to device intervals, kernel times by
name, the device time launched inside a host range, and the breakdown
(longest device operations, longest idle gaps with what the host was
doing)."""

from __future__ import annotations

import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

from harness import stats

RUNTIME = re.compile(r"^cu[A-Z]|^cuda[A-Z]")  # CUDA runtime and driver calls on the host


@dataclass
class Event:
    name: str
    kind: str  # activity type: cpu_op, user_annotation, cuda_runtime, kernel, gpu_memcpy, ...
    start: float  # seconds on the profiler's clock
    end: float
    corr: int
    thread: int


@dataclass
class Trace:
    start: float  # the stretch on the profiler's clock (seconds)
    end: float
    device: List[Event] = field(default_factory=list)
    host: List[Event] = field(default_factory=list)  # CUDA runtime and driver calls
    spans: List[Tuple[str, float, float]] = field(default_factory=list)  # the harness's, on the same clock
    thread: int = 0  # the thread that runs the steps
    diag: Dict[str, float] = field(default_factory=dict)  # event counts and spans, for the run's notes

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        return stats.covered([(e.start, e.end) for e in self.device], self.start, self.end)

    def kernel_seconds(self, patterns: List[str]) -> float:
        rx = re.compile("|".join(patterns))
        return sum(e.end - e.start for e in self.device if e.kind == "kernel" and rx.search(e.name))

    def device_seconds_inside(self, span: str) -> Tuple[float, int]:
        """(device seconds, spans): the device operations launched from the
        stepping thread inside the harness's spans named `span`."""
        ranges = [(a, b) for n, a, b in self.spans if n == span]
        launched = {e.corr for e in self.host if e.thread == self.thread
                    and any(a <= e.start <= b for a, b in ranges)}
        return sum(e.end - e.start for e in self.device if e.corr in launched), len(ranges)

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = defaultdict(float)
        for e in self.device:
            by_name[short_name(e.name)] += e.end - e.start
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        holes = sorted(stats.gaps([(e.start, e.end) for e in self.device], self.start, self.end),
                       key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.host_doing(a, b), b - a] for a, b in holes]}

    def host_doing(self, a: float, b: float) -> str:
        """What the stepping thread did through the gap (a, b): the harness's
        innermost span and the CUDA call (if any) at the gap's middle."""
        mid = (a + b) / 2
        spans = [(n, s, e) for n, s, e in self.spans if s <= mid <= e]
        span = min(spans, key=lambda x: x[2] - x[1])[0] if spans else "between the harness's spans"
        calls = [e for e in self.host if e.thread == self.thread and e.start <= mid <= e.end]
        call = calls[0].name if calls else "Python, no CUDA call"
        return f"{span} > {call}"


def short_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    name = re.sub(r"\(.*$", "", name)
    return name[:120]


def _ns(e, which: str) -> float:
    if hasattr(e, f"{which}_ns"):
        return getattr(e, f"{which}_ns")() * 1e-9
    if which == "start":
        return e.start_us() * 1e-6
    return (e.start_us() + e.duration_us()) * 1e-6


class Profiler:
    """A `torch.profiler` stretch of the device's activity (kernels, copies,
    fills and the host's CUDA calls; no host operators, which would slow the
    host's side of a step), between two device synchronisations.  Those two
    `cudaDeviceSynchronize` calls tie the profiler's clock to the host's
    `time.perf_counter`, so that spans the harness times itself (`span`)
    land on the trace's timeline."""

    def __init__(self):
        self.prof = None
        self.marks: List[float] = []
        self.spans: List[Tuple[str, float, float]] = []

    def span(self, name: str, t0: float, t1: float) -> None:
        self.spans.append((name, t0, t1))

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.marks = [time.perf_counter()]

    def stop(self) -> Trace:
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        self.prof.stop()
        events = self.prof.profiler.kineto_results.events()
        device, host = [], []
        for e in events:
            ev = Event(e.name(), str(e.activity_type()) if hasattr(e, "activity_type") else "",
                       _ns(e, "start"), _ns(e, "end"), int(e.correlation_id()), int(e.start_thread_id()))
            if "CUDA" in str(e.device_type()):
                if "annotation" not in ev.kind:
                    ev.kind = "memory" if ev.name.startswith(("Memcpy", "Memset")) else "kernel"
                    device.append(ev)
            elif RUNTIME.match(ev.name):
                host.append(ev)
        syncs = sorted((e for e in host if e.name.startswith("cudaDeviceSynchronize")), key=lambda e: e.end)
        self.prof = None
        if len(syncs) < 2:
            raise RuntimeError("the trace lacks its two cudaDeviceSynchronize marks")
        first, last = syncs[0], syncs[-1]
        diag = {"device_events": len(device), "host_events": len(host), "syncs": len(syncs),
                     "device_span_s": (max(e.end for e in device) - min(e.start for e in device)) if device else 0.0,
                     "host_span_s": (max(e.end for e in host) - min(e.start for e in host)) if host else 0.0,
                     "marks_s": self.marks[-1] - self.marks[0], "sync_span_s": last.end - first.end}
        offset = first.end - self.marks[0]  # profiler clock minus perf_counter
        spans = [(n, a + offset, b + offset) for n, a, b in self.spans]
        return Trace(first.end, last.end, device, host, spans, first.thread, diag)
