"""What the per-layer metric files share: the traced steps' real lengths
and a kernel's share of its roofline over the traced stretch."""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

from harness import flops, peaks, spec


def step_lengths(ctx: dict) -> List[Tuple[List[int], List[int]]]:
    """(xlens, ylens) of every micro-step of the traced stretch (training)
    or every batch decoded in it (decoding)."""
    pool = ctx["pool"]
    if ctx["train"]:
        return [([int(pool.frames[i]) for i in f.index], [len(pool.labels[i]) for i in f.index])
                for f in ctx["steps"]]
    return [([int(pool.frames[i]) for i in idx], [len(pool.labels[i]) for i in idx])
            for idx in ctx["decoded_batches"]]


def roofline(ctx: dict, kernel: str, launches: Callable[[List[int], List[int]], Iterable[Tuple[float, float]]]
             ) -> Optional[float]:
    """100 * (sum of the launches' least times) / (the kernel's device time),
    or None where the trace holds none of its launches."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    k = spec.kernel_counts(kernel)
    t = tr.kernel_seconds(k.NAMES)
    if t <= 0:
        return None
    bound = sum(peaks.bound_s(o, b) for xl, yl in step_lengths(ctx) for o, b in launches(xl, yl))
    return 100.0 * bound / t


def mfu(ctx: dict) -> Optional[float]:
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    cfg = ctx["cfg"]
    if ctx["train"]:
        work = sum(3 * flops.batch_forward(cfg, xl, yl) for xl, yl in step_lengths(ctx))
    else:
        work = sum(flops.decode_forward(cfg, xl) for xl, _ in step_lengths(ctx))
    return 100.0 * work / (tr.window_s * peaks.DENSE_FLOPS)


def idle(ctx: dict) -> Optional[float]:
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def elens(xlens: List[int]) -> List[int]:
    return [flops.subsampled(x) for x in xlens]
