"""Import hygiene: nothing under benchmark/ imports JAX or the JAX package
(compared by the whole top-level name), the reference imports nothing of
the port, and the only module of the harness that imports the port is
harness/port.py."""

import ast
import os

from bench_tiny import ROOT

BENCH = os.path.join(ROOT, "benchmark")
JAX = {"jax", "jaxlib", "flax", "pinot_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") in ("import_module",
                                                     "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for path in _sources():
        assert not set(_imports(path)) & JAX, path


def test_whole_top_level_names():
    # the port's name begins with the JAX package's; only whole names count
    assert "pinot_tpu_torch".split(".")[0] not in JAX


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        assert "pinot_tpu_torch" not in set(_imports(path)), path


def test_only_the_port_adapter_imports_the_port():
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        uses = "pinot_tpu_torch" in set(_imports(path))
        assert uses == path.endswith(os.path.join("harness", "port.py")), \
            path
