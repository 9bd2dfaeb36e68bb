"""What the per-layer metrics of the program's own spans share: the spans
that `emoasr_tpu_torch/utils/profile.py` recorded inside the traced
stretch, the device time and the kernels launched inside them, the
device's idle time inside them, their host time and their frame counts.

The program stamps its spans on the profiler's clock (Unix-epoch ns), so
they land on the `Trace` timeline (seconds) as they are.  A kernel belongs
to a span when its host launch call (joined by correlation id) started
inside the span's interval, from any thread: the backward's kernels are
launched by autograd's device thread while the stepping thread waits in
`train.backward`.  A program without spans (an older checkout) records
none, and every reader then returns None."""

from __future__ import annotations

from bisect import bisect_right
from typing import List, Optional, Sequence, Tuple

from harness import stats

Range = Tuple[float, float]


def records() -> list:
    """The program's span records, or [] where the program has no recorder."""
    from emoasr_tpu_torch.utils import profile

    return profile.records() if hasattr(profile, "records") else []


def spans(ctx: dict, name: str) -> list:
    """The records named `name` that lie inside the traced stretch."""
    tr = ctx.get("trace")
    if tr is None:
        return []
    return [r for r in records() if r.name == name and tr.start <= r.start_ns * 1e-9 and r.end_ns * 1e-9 <= tr.end]


def ranges(recs: Sequence) -> List[Range]:
    return [(r.start_ns * 1e-9, r.end_ns * 1e-9) for r in recs]


class _Inside:
    """Membership of a time in a union of intervals (bisection)."""

    def __init__(self, intervals):
        self.iv = stats.union(intervals)
        self.starts = [a for a, _ in self.iv]

    def __contains__(self, t: float) -> bool:
        i = bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.iv[i][1]

    def covered(self, a: float, b: float) -> float:
        """Length of [a, b] that the intervals cover."""
        i, out = max(bisect_right(self.starts, a) - 1, 0), 0.0
        while i < len(self.iv) and self.iv[i][0] < b:
            s, e = self.iv[i]
            out += max(0.0, min(e, b) - max(s, a))
            i += 1
        return out


def kernels_inside(tr, rs: Sequence[Range]) -> Tuple[float, int]:
    """(device seconds, kernels) of the kernels (not copies or fills) whose
    launch call, on any thread, started inside the ranges."""
    inside = _Inside(rs)
    launched = {e.corr for e in tr.host if e.start in inside}
    ks = [e for e in tr.device if e.kind == "kernel" and e.corr in launched]
    return sum(e.end - e.start for e in ks), len(ks)


def idle_inside(tr, rs: Sequence[Range]) -> float:
    """Seconds of the ranges that no kernel, copy or fill on the device covers."""
    busy = _Inside((e.start, e.end) for e in tr.device)
    return sum((b - a) - busy.covered(a, b) for a, b in rs)


def device_ms(ctx: dict, name: str) -> Optional[float]:
    """Device time launched inside the spans `name`, a span (ms)."""
    recs = spans(ctx, name)
    if not recs:
        return None
    return 1e3 * kernels_inside(ctx["trace"], ranges(recs))[0] / len(recs)


def launches(ctx: dict, name: str) -> Optional[float]:
    """Kernels launched inside the spans `name`, a span."""
    recs = spans(ctx, name)
    if not recs:
        return None
    return kernels_inside(ctx["trace"], ranges(recs))[1] / len(recs)


def idle_ms(ctx: dict, name: str, per: str) -> Optional[float]:
    """Device idle time inside the spans `name`, a span `per` (ms)."""
    recs, n = spans(ctx, name), len(spans(ctx, per))
    if not recs or not n:
        return None
    return 1e3 * idle_inside(ctx["trace"], ranges(recs)) / n


def host_ms(ctx: dict, name: str, per: str) -> Optional[float]:
    """Host time in the spans `name`, a span `per` (ms)."""
    recs, n = spans(ctx, name), len(spans(ctx, per))
    if not recs or not n:
        return None
    return 1e-6 * sum(r.end_ns - r.start_ns for r in recs) / n


def pad_share(ctx: dict, name: str) -> Optional[float]:
    """100 * (1 - real / padded frames) of the batches collated in the spans `name`."""
    recs = spans(ctx, name)
    real = sum(r.counts.get("frames.real", 0) for r in recs)
    padded = sum(r.counts.get("frames.padded", 0) for r in recs)
    return 100.0 * (1.0 - real / padded) if padded else None
