"""Nothing of the harness, the reference or a cell's path loads JAX, flax,
the JAX package or the chip smoke script; the reference imports nothing of
the program."""

import ast
import os
import subprocess
import sys

from harness import spec

CHECK = r"""
import sys
sys.path[:0] = [{bench!r}, {root!r}]
import harness.driver, harness.train_phase, harness.decode_phase, harness.readers, harness.trace
import reference.common, reference.ctc_transformer, reference.rnnt_conformer
from harness import spec
for n in spec.all_names("metrics"):
    spec.metric_reader(n)
for n in spec.all_names("kernels"):
    spec.kernel_counts(n)
import emoasr_tpu_torch.train.loop, emoasr_tpu_torch.train.step, emoasr_tpu_torch.eval.test_asr
import emoasr_tpu_torch.eval.decode, emoasr_tpu_torch.data.asr_dataset
from harness.common import loaded_forbidden
print(loaded_forbidden())
"""


def test_no_forbidden_module_in_a_cells_process():
    code = CHECK.format(bench=spec.BENCH_DIR, root=spec.ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole():
    from harness import common

    saved = dict(sys.modules)
    try:
        sys.modules["emoasr_tpu_torch_x"] = sys
        assert "emoasr_tpu" not in common.loaded_forbidden()
        sys.modules["emoasr_tpu.sub"] = sys
        assert "emoasr_tpu" in common.loaded_forbidden()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(spec.BENCH_DIR, "reference")
    for f in os.listdir(ref):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, f)).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("emoasr_tpu_torch", "emoasr_tpu", "jax", "flax", "harness"), (f, n)
