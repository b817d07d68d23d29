"""What a run imports: never JAX nor the JAX package, and the reference
nothing of the program."""

import ast
import os
import sys
import types

from benchmark import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        if os.sep + "tests" in d:
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_the_check_compares_whole_top_level_names(monkeypatch):
    import nisqa_tpu_torch  # noqa: F401

    assert "nisqa_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "nisqa_tpu.model", types.ModuleType("nisqa_tpu.model"))
    assert harness.forbidden_modules() == ["nisqa_tpu"]
    monkeypatch.delitem(sys.modules, "nisqa_tpu.model")
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert harness.forbidden_modules() == ["jaxlib"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


def test_the_reference_and_the_counts_import_nothing_of_the_program():
    for sub in ("reference", "counts"):
        for path in _sources(sub):
            assert all(not m.startswith("nisqa_tpu") for m in _imports(path)), path
