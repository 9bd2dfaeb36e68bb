"""One run of one cell: the phase's run, the per-layer readers over its
trace, the comparison's numbers, and the result line."""

from __future__ import annotations

import importlib
import json
import sys
from typing import Optional

import torch

from harness import common, spec


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, work_dir: str, t0: float,
             dtype: Optional[str] = None, fault: Optional[str] = None, updates: Optional[int] = None) -> Optional[dict]:
    """The result line of one run (None where the run may print none)."""
    common.env_threads()
    run = common.Run(cell, int(seed), float(seconds), trace, torch.device(device), work_dir, t0,
                     dtype=dtype, fault=fault, updates=updates)
    phase = importlib.import_module(f"harness.{cell.phase}_phase")
    res, ctx = phase.run(run)
    res.metrics = {m["name"]: {"value": res.metrics[m["name"].split(".")[0]]["value"], "unit": m["unit"]}
                   for m in cell.end_to_end}
    if trace and device.type == "cuda":
        res.metrics = per_layer(cell, ctx)
        tr = ctx["trace"]
        res.device["busy_s"] = tr.busy_s()
        res.device["window_s"] = tr.window_s
        res.breakdown = tr.breakdown()
        res.notes["kernels"] = tr.breakdown(top=60)["device_ops"]
        res.notes["trace"] = tr.diag
    res.device["power"] = common.power_limit() if device.type == "cuda" else "cpu"
    print(json.dumps({"notes": res.notes, "problems": res.problems}, default=float), file=sys.stderr)
    found = common.loaded_forbidden()
    for c in res.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r}", file=sys.stderr)
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return None
    line = {"correct": res.correct, "attempted": res.attempted, "failed": res.failed,
            "metrics": res.metrics, "device": res.device}
    if res.breakdown is not None:
        line["breakdown"] = res.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in res.checks}
    return line


def per_layer(cell: spec.Cell, ctx: dict) -> dict:
    """{name: {"value", "unit"}} of the cell's per-layer metrics that found
    something to read."""
    out = {}
    for m in cell.per_layer:
        reader = spec.metric_reader(m["name"])
        v = reader.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
