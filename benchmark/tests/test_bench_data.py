"""Every configuration, traffic, metric and kernel file loads by name, and
BENCHMARK.json keeps to the benchmark's contract."""

import json
import os
import re

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))


def test_every_data_file_loads_by_name():
    for name in spec.all_names("configs"):
        c = spec.load_json(spec.all_names("configs")[name])
        assert {"source", "reduced", "config", "harness", "limits"} <= set(c)
        from emoasr_tpu_torch.config import config_from_dict
        config_from_dict(c["config"])
    for name in spec.all_names("traffic"):
        assert spec.load_json(spec.all_names("traffic")[name])["phase"] in ("train", "decode")
    for name in spec.all_names("metrics"):
        m = spec.metric_reader(name)
        assert callable(m.read) and m.UNIT and m.LAYER and m.MOVES
    for name in spec.all_names("kernels"):
        k = spec.kernel_counts(name)
        assert k.NAMES


def test_benchmark_json_follows_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = [x["name"] for x in b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"]: c for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(spec.ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["config"] in configs
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        cell = spec.load_cell(w["name"])
        assert any(m["name"] != "setup_s" for m in cell.end_to_end) and cell.per_layer
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        reader = spec.metric_reader(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (m["unit"], m["layer"], m["moves"])
        for w in m.get("workloads", []):
            assert spec.applies(e2e[m["moves"]], w)
    assert len(json.dumps(b)) < 64 * 1024
