"""Nothing under portbench/ imports JAX, its libraries or the JAX package
(top-level module names compared whole: the program's name begins with
the JAX package's), and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from harness import bench

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(bench.BENCH_DIR) for f in fs
               if f.endswith(".py"))


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, bench.BENCH_DIR))
def test_no_jax(path):
    assert not set(imported(path)) & set(bench.FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in FILES if os.sep + "reference" + os.sep in p],
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert set(imported(path)) <= {"__future__", "math", "dataclasses", "numpy", "torch"}


@pytest.mark.parametrize("name,found", [
    ("portrayer_tpu_torch.render", []),
    ("portrayer_tpu.render", ["portrayer_tpu"]),
    ("jax.numpy", ["jax"]),
    ("jaxlib", ["jaxlib"]),
    ("jax_free_module", []),
])
def test_names_compared_whole(name, found, monkeypatch):
    monkeypatch.setattr(sys, "modules", {name: None})
    assert bench.forbidden_modules() == found


def test_a_run_loads_no_jax():
    """A render cell's run, cut to the CPU test size, in a process of its
    own: no forbidden module is loaded once it has closed."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from _small import small_cell\n"
        "from harness import bench\n"
        "import portrayer_tpu_torch as T\n"
        "spec, data, traffic, limits = small_cell('big-scene.spp1', (32, 16))\n"
        "rec = bench.run_cell(T, data, traffic, limits, 3, 0.0, False, 'cpu', 0.0)\n"
        "print(rec['correct'], bench.forbidden_modules())\n"
    ) % (os.path.dirname(os.path.abspath(__file__)), bench.BENCH_DIR)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=bench.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "True []"


def test_without_a_card_it_prints_no_result():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "big-scene.spp1",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=bench.ROOT)
    assert out.returncode != 0 and out.stdout == ""
