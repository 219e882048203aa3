"""Nothing the benchmark loads is JAX or the JAX package, and the reference loads nothing of the port.

Module names are compared by their top-level part (before the first dot) whole: the port's
``dialog_tpu_torch`` begins with ``dialog_tpu`` and is not the JAX package.
"""

from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dialog_tpu"}


def loaded_after(code: str) -> set[str]:
    """Top-level names of the modules loaded by ``code`` in a fresh interpreter with JAX kept away."""
    prog = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    env = dict(os.environ, PYTHONPATH=str(ROOT), USE_FLAX="0")
    p = subprocess.run([sys.executable, "-c", prog], cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.splitlines()[-1]))


def test_the_harness_and_the_port_load_no_jax():
    code = ("import bench_port.run, bench_port.harness, bench_port.checks, bench_port.trace, bench_port.tools.series\n"
            "import dialog_tpu_torch, dialog_tpu_torch.system, dialog_tpu_torch.stereo, dialog_tpu_torch.kernels.build\n"
            "for m in ('device_idle_pct', 'schur_roofline_pct', 'track_host_ms.multi'): bench_port.run.load_reader(m)")
    tops = loaded_after(code)
    assert "dialog_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    tops = loaded_after("import bench_port.reference.frontend, bench_port.reference.matching, "
                        "bench_port.reference.pose, bench_port.reference.schur")
    assert "dialog_tpu_torch" not in tops and not tops & FORBIDDEN


def test_no_source_of_the_benchmark_imports_jax_or_reads_the_root_bench():
    for path in HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)
                if "reference" in path.parts:
                    assert n.split(".")[0] != "dialog_tpu_torch", (path, n)
        if "tests" not in path.parts:
            opened = [c.value for c in ast.walk(tree) if isinstance(c, ast.Constant) and isinstance(c.value, str)
                      and c.value.rstrip("/").endswith("bench.py")]
            assert not opened, (path, opened)
