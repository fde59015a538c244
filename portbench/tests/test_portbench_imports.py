"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program either; without a CUDA card the
command fails and prints no result."""
import ast
import json
import os
import shutil
import subprocess
import sys

import bench_paths
from bench_paths import BENCH, REPO

from lib import imports

ENV = dict(os.environ, PYTHONPATH="")


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, json\n"
         f"sys.path[:0] = [{BENCH!r}, {REPO!r}]\n" + code +
         "\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, env=ENV, cwd=REPO, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_top_level_names_compared_whole():
    assert imports.top_level("yunikorn_tpu_torch.core.scheduler") == \
        "yunikorn_tpu_torch"
    assert imports.forbidden_loaded({"yunikorn_tpu_torch": 1,
                                     "yunikorn_tpu_torch.ops": 1}) == set()
    assert imports.forbidden_loaded({"yunikorn_tpu.ops": 1, "jaxlib": 1,
                                     "jax_free": 1}) == {"yunikorn_tpu",
                                                         "jaxlib"}


def test_harness_and_program_load_no_jax():
    names = loaded_after(
        "import run\nfrom lib import harness, judge, program, trace, "
        "faults\nharness.loop_of('waves')\n"
        "import yunikorn_tpu_torch.core.scheduler")
    assert "yunikorn_tpu_torch" in names
    assert not names & imports.FORBIDDEN


def test_reference_loads_neither_jax_nor_the_program():
    names = loaded_after("from reference import check, greedy")
    assert not names & (imports.FORBIDDEN | {"yunikorn_tpu_torch", "lib"})


def test_reference_sources_import_nothing_of_the_program():
    for name in os.listdir(os.path.join(BENCH, "reference")):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(BENCH, "reference", name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in (
                    imports.FORBIDDEN | {"yunikorn_tpu_torch", "lib"}), \
                    f"{name} imports {m}"


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "kwok-10k-pack.burst", "--seed", "2147483999", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=REPO, env=ENV)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "kwok-10k-pack.burst", "--seed", "5", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        env=ENV)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
