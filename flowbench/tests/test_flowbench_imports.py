"""Nothing under flowbench/ imports JAX or the JAX package `tpuflow`;
top-level names are compared whole, so `tpuflow_torch` passes."""

import ast
import subprocess
import sys
from pathlib import Path

from flowbench import layout, run

FORBIDDEN = {"jax", "jaxlib", "flax", "tpuflow"}


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_tpuflow():
    files = list(layout.HERE.rglob("*.py"))
    assert len(files) > 20
    bad = {str(p): sorted(set(_imported(p)) & FORBIDDEN) for p in files}
    assert not {p: b for p, b in bad.items() if b}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpuflow_torch_fake", object())
    assert "tpuflow" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpuflow.fake", object())
    assert "tpuflow" in run.forbidden_modules()


def test_a_run_loads_no_jax():
    code = ("import sys; from flowbench import layout, run; "
            "b = layout.load_benchmark(); "
            "[layout.Cell(b, w['name']) for w in b['workloads']]; "
            "[layout.module(layout.HERE, 'metrics', p.stem) "
            "for p in (layout.HERE / 'metrics').glob('*.py')]; "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=layout.ROOT, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, "-m", "flowbench.run", "--workload",
                          "brox-sintel.pair", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=layout.ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout == ""
