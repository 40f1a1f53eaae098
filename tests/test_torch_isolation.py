"""The port stands alone: no module of orb_slam2_2021_tpu_torch, and none of
the programs that run on the card (chip_smoke.py, bench_torch.py, the
dataset program run_slam.py, the map processor's CLI,
tests/test_torch_cuda.py, scripts/torch_*.py), imports JAX or anything of the JAX package. The only
thing the port takes from that package's directory is the vocabulary data,
read by path.
"""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFUSED = ("jax", "jaxlib", "orb_slam2_2021_tpu")
CARD_PROGRAMS = ["chip_smoke.py", "bench_torch.py", "orb_slam2_2021_tpu_torch/run_slam.py",
                 "orb_slam2_2021_tpu_torch/pipeline/streams.py",
                 "orb_slam2_2021_tpu_torch/io/datasets.py",
                 "orb_slam2_2021_tpu_torch/tools/map_processor.py", "tests/test_torch_cuda.py"] + sorted(
    os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "scripts", "torch_*.py")))


def test_every_port_module_imports_with_jax_refused():
    """In a fresh process whose import system refuses jax and the JAX
    package, import every module of the port."""
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        REFUSED = {REFUSED!r}

        def refused(name):
            return any(name == r or name.startswith(r + ".") for r in REFUSED)

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if refused(name):
                    raise ImportError(f"refused import of {{name}}")
                return None

        for name in [m for m in sys.modules if refused(m)]:
            del sys.modules[name]
        sys.meta_path.insert(0, Refuse())
        import orb_slam2_2021_tpu_torch as pkg
        names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."))
        for name in names:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules if refused(m))
        assert not leaked, leaked
        print(len(names), "OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), res.stderr[-3000:]
    assert int(res.stdout.split()[-2]) > 40, res.stdout


def _imported_names(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", CARD_PROGRAMS)
def test_card_programs_import_nothing_of_jax(path):
    names = list(_imported_names(path))
    assert names, f"{path}: no imports found"
    bad = [n for n in names if n.split(".")[0] in REFUSED]
    assert not bad, f"{path} imports {bad}"
