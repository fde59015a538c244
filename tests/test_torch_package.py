"""The port's package boundary: it imports neither JAX nor the JAX package,
its entry points run on the card unless asked for the CPU, and its smoke
script refuses to run without a CUDA device."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "yunikorn_tpu_torch"
PORT_FILES = sorted(p for p in PORT.rglob("*") if p.suffix in (".py", ".cu"))
NAMES_JAX = re.compile(r"\bjax\b|yunikorn_tpu(?!_torch)")
IMPORTS_JAX = re.compile(
    r"^\s*(import|from)\s+(jax\b|yunikorn_tpu\b(?!_torch))", re.M)


def port_modules():
    mods = []
    for p in PORT.rglob("*.py"):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return sorted(mods)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.split('.')[0] in ('yunikorn_tpu', 'jaxlib'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_port_file_names_jax_or_the_jax_package():
    assert PORT_FILES
    offenders = [str(p) for p in PORT_FILES if NAMES_JAX.search(p.read_text())]
    assert offenders == []
    assert not IMPORTS_JAX.search((ROOT / "chip_smoke.py").read_text())


def test_entry_points_raise_without_cuda(monkeypatch):
    from test_torch_encoder import build_mixed
    from yunikorn_tpu_torch.ops import assign
    from yunikorn_tpu_torch.utils.torchtools import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc, batch, _ = build_mixed("yunikorn_tpu_torch", n_nodes=4, n_pods=8)
    np_args, static = assign.prepare_solve_args(batch, enc.nodes)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        assign.solve_batch(batch, enc.nodes)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        assign.solve(*np_args[:23], **static)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        assign.solve_chunked(*np_args[:23], chunk_pods=64, **static)
    res = assign.solve_batch(batch, enc.nodes, device="cpu")
    assert res.assigned.device.type == "cpu" and int(res.assigned.max()) >= 0

    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.cmd import policy_train
    from yunikorn_tpu_torch.core.shard import make_core_scheduler
    from yunikorn_tpu_torch.ops.ledger_mirror import DeviceUsageMirror
    from yunikorn_tpu_torch.policy import train

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.fit([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        policy_train.main(["--dataset", ".", "--out", "unused"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_core_scheduler(SchedulerCache(), shards=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceUsageMirror(2)

    from yunikorn_tpu_torch.cmd import scheduler as cmd
    from yunikorn_tpu_torch.conf.schedulerconf import reset_for_tests
    from yunikorn_tpu_torch.shim.mock_scheduler import MockScheduler

    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MockScheduler().init()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cmd.main(["--nodes", "2", "--rest-port", "0"])
        ms = MockScheduler()
        ms.init(device="cpu")
        try:
            assert ms.core.device.type == "cpu"
        finally:
            ms.stop()
    finally:
        reset_for_tests()


def test_importing_the_port_starts_no_thread():
    code = (
        "import importlib, sys, threading\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(t.name for t in threading.enumerate()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['MainThread']"


@pytest.mark.parametrize("missing", ["cuda", "package"])
def test_chip_smoke_refuses_to_run(missing, monkeypatch, capsys):
    """Without a CUDA device, or without the port's package beside it (the
    script alone in a directory), chip_smoke.py exits non-zero and prints
    no result."""
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: missing != "cuda")
    if missing == "package":
        monkeypatch.setitem(sys.modules, "yunikorn_tpu_torch", None)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""
