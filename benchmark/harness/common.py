"""What every phase shares: the run's context, the configuration as the
program takes it, the device's description, the comparison's numbers and
the result line."""

from __future__ import annotations

import os
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from harness.spec import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "emoasr_tpu", "chip_smoke")


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    work_dir: str  # the run's pool, under TMPDIR
    t0: float  # the process's start on `time.perf_counter`
    dtype: Optional[str] = None  # a control: the program at another compute dtype
    fault: Optional[str] = None  # a planted fault (benchmark/control.py and the tests)
    updates: Optional[int] = None  # optimizer updates that the check follows (training)


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


@dataclass
class Result:
    metrics: Dict[str, dict] = field(default_factory=dict)
    checks: List[Check] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    sound: bool = True  # the run did what the configuration states
    problems: List[str] = field(default_factory=list)
    device: Dict[str, object] = field(default_factory=dict)
    breakdown: Optional[dict] = None
    notes: Dict[str, object] = field(default_factory=dict)  # printed on an earlier line

    @property
    def correct(self) -> bool:
        return self.sound and bool(self.checks) and all(c.ok for c in self.checks)


def program_config(run: Run, overrides: dict):
    """The configuration file's `config` with the run's paths and seed (and
    the control's dtype) as the port's `ExpConfig`."""
    from emoasr_tpu_torch.config import config_from_dict

    raw = dict(run.cell.config["config"])
    raw.update(overrides)
    raw["seed"] = int(run.seed)
    if run.dtype:
        raw["compute_dtype"] = run.dtype
    return config_from_dict(raw), raw


def seeds(run: Run) -> Dict[str, int]:
    """Seeds of the run's parts, each from --seed."""
    ss = np.random.SeedSequence(int(run.seed))
    w, = ss.generate_state(1, dtype=np.uint64)
    return {"weights": int(w) >> 1}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def device_info(run: Run) -> dict:
    dev = run.device
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(dev),
        "count": run.cell.chips,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
    }


def loaded_forbidden() -> List[str]:
    """Modules of JAX, flax, the JAX package or the chip smoke script in
    this process, by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def relative_gap(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor)


def free_device(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def env_threads() -> None:
    """One process with few threads keeps a run's load steady."""
    n = max(1, min(4, (os.cpu_count() or 1) // 2))
    torch.set_num_threads(n)
