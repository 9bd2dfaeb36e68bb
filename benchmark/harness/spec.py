"""The benchmark's data, found by name.

`BENCHMARK.json` at the root of the checkout names the cells
(`workloads`), each of which names a configuration (`configs/<name>.json`
under this folder, through the entry's `file`), a traffic mix
(`traffic/<name>.json`) and the metrics it reports.  A per-layer metric is
`metrics/<name>.py`, a kernel's operation and byte counts
`kernels/<name>.py`, a model family's plain reference `reference/<name>.py`
(named by the configuration's `harness.reference`), a phase
`harness/<phase>_phase.py` (named by the traffic's `phase`).
Nothing here names a cell: adding one is adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: Optional[str] = None) -> ModuleType:
    """Import a file by path (metric files carry dots in their names)."""
    name = name or "bench_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict  # the configuration file: `config` (the yaml's keys as run) and the harness's keys
    traffic_name: str
    traffic: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    @property
    def phase(self) -> str:
        return self.traffic["phase"]


def applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell `workload` of `root/BENCHMARK.json`, with its configuration,
    traffic and the metrics it reports."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    by_name = {w["name"]: w for w in spec["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = by_name[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config_name=w["config"],
        config=load_json(os.path.join(root, conf["file"])),
        traffic_name=w["traffic"],
        traffic=load_json(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json")),
        end_to_end=[m for m in spec["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if applies(m, workload)],
    )


def metric_reader(name: str) -> ModuleType:
    """`metrics/<name>.py`: UNIT, LAYER, MOVES and read(ctx) -> float | None."""
    return load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"))


def kernel_counts(name: str) -> ModuleType:
    """`kernels/<name>.py`: NAMES (regexes of the kernel's device functions)
    and one function a launcher, (shapes, real lengths) -> (ops, bytes)."""
    return load_module(os.path.join(BENCH_DIR, "kernels", name + ".py"))


def all_names(kind: str) -> Dict[str, str]:
    """{name: path} of every data file of `kind` (configs, traffic, metrics, kernels)."""
    d = os.path.join(BENCH_DIR, kind)
    return {os.path.splitext(f)[0]: os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.endswith((".json", ".py")) and not f.startswith("_")}
