"""What the benchmark may import: nothing whose top-level name is JAX's
or the JAX package's, anywhere under ``benchmark/``; and, in the plain
references, nothing of the program either. Names are compared whole:
the port's package name begins with the JAX package's."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEVER = {"jax", "jaxlib", "flax", "seldon_core_tpu"}
PROGRAM = "seldon_core_tpu_torch"


def sources(sub=""):
    root = os.path.join(HERE, sub)
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    """Top-level module names imported by the file, by statement and by
    ``importlib.import_module("...")`` with a constant name."""
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            out.add(node.args[0].value.split(".")[0])
    return out


def test_nothing_under_benchmark_imports_jax_or_the_jax_package():
    found = {p: top_level_imports(p) & NEVER for p in sources()}
    assert not {p: n for p, n in found.items() if n}


def test_the_references_import_nothing_of_the_program():
    paths = list(sources("reference"))
    assert paths
    for p in paths:
        names = top_level_imports(p)
        assert PROGRAM not in names and not (names & NEVER), p


def test_the_scan_sees_what_it_must(tmp_path):
    p = tmp_path / "scanned.py"
    p.write_text("import jax.numpy as jnp\nfrom seldon_core_tpu.models import x\n"
                 "import seldon_core_tpu_torch\nimport importlib\n"
                 "importlib.import_module('flax.linen')\n")
    names = top_level_imports(str(p))
    assert names & NEVER == {"jax", "seldon_core_tpu", "flax"}
    assert PROGRAM in names


@pytest.mark.parametrize("name", ["seldon_core_tpu_torch.models", "jaxtyping", "flaxen"])
def test_whole_names_only(name):
    from benchmark.run import FORBIDDEN

    assert name.split(".")[0] not in FORBIDDEN
