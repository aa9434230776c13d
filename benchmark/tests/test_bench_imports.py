"""Nothing a run loads has the top-level name jax, jaxlib, flax or
mpsnerf_tpu (compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the port."""

import ast
import subprocess
import sys

from conftest import BENCH, REPO, run_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "mpsnerf_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "mpsnerf_torch" not in tops and not tops & FORBIDDEN, path
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.plain; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out))
    assert "mpsnerf_torch" not in tops and not tops & FORBIDDEN


def test_a_run_loads_no_jax(tiny_root, tmp_path):
    """A whole CPU run, traced, ends with the harness's own look at
    ``sys.modules`` passing (it exits 4 and prints no result where it
    finds one of the names)."""
    rc, line, err = run_cell(tiny_root, "flagship.train", trace=1)
    assert rc == 0, err[-3000:]
    assert line is not None and line["correct"], err[-2000:]


def test_the_look_compares_whole_names(monkeypatch):
    from benchmark.harness import main

    monkeypatch.setitem(sys.modules, "jaxlike_module", sys)
    monkeypatch.setitem(sys.modules, "mpsnerf_tpu_extra", sys)
    assert main.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert main.forbidden_modules() == ["jaxlib"]
