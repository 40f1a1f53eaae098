"""No module under slam_bench/ imports JAX or the JAX package, and the
plain reference imports nothing of the program either. Names are compared
by their whole top-level part (the port's name begins with the JAX
package's)."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "orb_slam2_2021_tpu"}
PROGRAM = "orb_slam2_2021_tpu_torch"


def _modules():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, HERE))
def test_imports(path):
    names = set(_top_level_imports(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    if os.path.relpath(path, HERE).startswith("reference" + os.sep):
        assert PROGRAM not in names
        assert not any(n == "slam_bench" for n in names)


def test_the_scan_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import orb_slam2_2021_tpu_torch.config\nfrom orb_slam2_2021_tpu.x import y\nimport jaxtyping\n")
    assert set(_top_level_imports(str(p))) == {"orb_slam2_2021_tpu_torch", "orb_slam2_2021_tpu", "jaxtyping"}
