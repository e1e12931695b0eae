"""Nothing the benchmark imports is JAX or the JAX package (compared by
whole top-level module names), and the reference imports nothing of the
port."""

import ast
import os
import subprocess
import sys

from d3h_bench.registry import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "d3human_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(ROOT, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        assert "d3human_tpu_torch" not in set(_imports(path)), path


def test_a_run_holds_no_jax_module():
    code = ("import torch; torch.set_num_threads(2)\n"
            "from d3h_bench import run\n"
            "from d3h_bench.tests.conftest import DATA\n"
            "run.run('tiny.init', 3, 0.1, False, 'cpu', root=DATA)\n"
            "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_main_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "d3h_bench.run", "--workload", "f3c.init",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=os.path.dirname(ROOT),
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
