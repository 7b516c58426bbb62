"""The import guard compares whole top-level module names, and the
reference imports nothing of the program."""

import os
import subprocess
import sys
import types

from harness import core


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "opticommpy_torchish", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "opticommpy_tpu.models", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("x"))
    assert core.forbidden_modules() == ["jaxlib", "opticommpy_tpu"]


def test_reference_imports_nothing_of_the_program(tmp_path):
    assert core.reference_imports() == []
    (tmp_path / "a.py").write_text("import numpy\nfrom opticommpy_torch.ops import pnorm\n")
    (tmp_path / "b.py").write_text("from jax import numpy as jnp\nimport opticommpy_tpu\n")
    (tmp_path / "c.py").write_text("import opticommpy_torchlike\nfrom . import sibling\n")
    assert core.reference_imports(str(tmp_path)) == [
        ("a.py", "opticommpy_torch.ops"), ("b.py", "jax"), ("b.py", "opticommpy_tpu")]


def test_cpu_run_loads_no_jax(cpu_run):
    cpu_run("dvbs2.decode")
    assert core.forbidden_modules() == []


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the command fails and prints no result; so it
    does in a directory that holds only the benchmark (no program)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd in (core.ROOT, str(tmp_path)):
        if cwd != core.ROOT:
            subprocess.run(["cp", "-r", core.HERE, os.path.join(core.ROOT, "BENCHMARK.json"),
                            cwd], check=True)
        p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "dvbs2.decode",
                            "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=300)
        assert p.returncode != 0
        assert '"correct"' not in p.stdout
