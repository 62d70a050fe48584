"""No module of the benchmark imports JAX or the JAX package, and the plain
references import nothing of the program either.  Top-level module names
are compared whole: the port's name begins with the JAX package's."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "flax", "optax", "unet_design_tpu", "benchmark"}
REFERENCE_BANNED = BANNED | {"unet_design_tpu_torch"}


def modules():
    for root, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_banned_import(path):
    banned = (REFERENCE_BANNED if os.sep + "reference" + os.sep in path
              else BANNED)
    found = set(imported_tops(path)) & banned
    assert not found, found


def test_guard_compares_whole_names():
    assert "unet_design_tpu_torch" not in BANNED
    from h100bench import harness
    assert "unet_design_tpu_torch" not in harness.BANNED
    assert set(harness.BANNED) == BANNED - {"benchmark"}


def test_spans_name_no_banned_module():
    import json
    for f in os.listdir(os.path.join(BENCH, "configs")):
        with open(os.path.join(BENCH, "configs", f)) as fh:
            spans = json.load(fh).get("spans", {})
        for path in spans.values():
            assert path.split(":")[0].split(".")[0] not in BANNED
