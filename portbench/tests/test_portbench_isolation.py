"""The benchmark measures the port alone: a run loads neither JAX nor the
JAX package (top-level names compared whole: segclip_tpu_torch begins with
segclip_tpu), and the reference imports nothing of the port."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
import textwrap

from portbench import run
from portbench.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "segclip_tpu"}
PB = tiny.ROOT / "portbench"


def imported_roots(path):
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_whole_name_comparison():
    import segclip_tpu_torch  # noqa: F401
    assert "segclip_tpu_torch".startswith("segclip_tpu")
    assert "segclip_tpu_torch" not in run.loaded_forbidden()


def test_no_source_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        assert not imported_roots(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in (PB / "reference").glob("*.py"):
        roots = imported_roots(path)
        assert not roots & (FORBIDDEN | {"segclip_tpu_torch"}), (path, roots)
        assert roots <= {"__future__", "math", "dataclasses", "typing", "gzip", "html",
                         "functools", "pathlib", "numpy", "torch", "regex", "portbench"}, roots
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module.startswith("portbench"):
                assert node.module.startswith("portbench.reference"), (path, node.module)


def test_a_run_loads_no_jax(tmp_path):
    """A whole CPU run of each kind of cell in a fresh process, then the
    modules it holds."""
    root = tiny.tiny_root(tmp_path)
    code = textwrap.dedent(f"""
        import json, sys, torch
        sys.path.insert(0, {str(tiny.ROOT)!r})
        from portbench import run
        from portbench.tests import tiny
        for cell in (tiny.TRAIN_CELL, tiny.EVAL_CELL):
            run.run(tiny.args(cell), root=__import__("pathlib").Path({str(root)!r}),
                    device=torch.device("cpu"))
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    roots = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "segclip_tpu_torch" in roots and not roots & FORBIDDEN
