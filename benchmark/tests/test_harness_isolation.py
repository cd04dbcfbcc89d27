"""The benchmark measures the port alone: nothing it runs imports JAX, the
JAX package or the JAX package's root files, and the plain references
import nothing of the port either. Top-level module names are compared as
whole words (``perseus_tpu_torch`` begins with ``perseus_tpu``)."""

import ast
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "perseus_tpu", "bench", "__graft_entry__")


def _files(root):
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    files = [f for f in _files(BENCH) if os.sep + "tests" + os.sep not in f]
    names = {os.path.relpath(f, BENCH) for f in files}
    for rel in ("run.py", "harness.py", "inputs.py", "counts.py", "controls.py", "traffic/camera.py",
                "traffic/resident_train.py", "metrics/serve.idle_share.py", "reference/smoother.py"):
        assert rel.replace("/", os.sep) in names, rel
    bad = [f"{os.path.relpath(p, BENCH)}: {m}" for p in files for m in _imports(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_the_references_import_nothing_of_the_port():
    files = _files(os.path.join(BENCH, "reference"))
    assert len(files) >= 4
    bad = [
        f"{os.path.relpath(p, BENCH)}: {m}"
        for p in files
        for m in _imports(p)
        if m.split(".")[0] in FORBIDDEN + ("perseus_tpu_torch",) or (m.startswith("benchmark.") and not m.startswith("benchmark.reference"))
    ]
    assert not bad, bad


def test_the_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types

    from benchmark import harness

    monkeypatch.setitem(sys.modules, "perseus_tpu.models", types.ModuleType("perseus_tpu.models"))
    assert "perseus_tpu" in harness.forbidden_modules()
    monkeypatch.delitem(sys.modules, "perseus_tpu.models")
    monkeypatch.setitem(sys.modules, "perseus_tpu_torch_extra", types.ModuleType("perseus_tpu_torch_extra"))
    assert "perseus_tpu" not in harness.forbidden_modules()
