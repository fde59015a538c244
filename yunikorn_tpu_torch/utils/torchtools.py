"""Device resolution and the CUDA kernel build: the port's counterpart of the
JAX package's utils/jaxtools.py.

Entry points run on the card unless the caller asks for the CPU: with no
device given they take `cuda`, and with no CUDA device they raise rather than
carry on quietly on the CPU.

Kernels are CUDA C++ sources under `yunikorn_tpu_torch/csrc/`, compiled at
first use with `nvcc` into shared libraries with a plain C interface (loaded
through ctypes) under `build/kernels/` at the repository root. A library's
file name carries a hash of its source, so an edited source is rebuilt and a
stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# ptxas resource report of each build (registers, shared memory, spills)
build_logs: Dict[str, str] = {}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` as given, else `cuda`.

    Raises when no device is given and no CUDA device is present: the
    plain PyTorch path on the CPU runs only when asked for explicitly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run its plain PyTorch path on the CPU")
    return torch.device("cuda")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str) -> Optional[subprocess.Popen]:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish_build(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    build_logs[name] = log
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str]) -> None:
    """Compile every named source that has no current library, all nvcc
    processes started together."""
    names = list(names)
    procs = [(n, _start_build(n)) for n in names]
    errors = []
    for n, p in procs:
        try:
            _finish_build(n, p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu's library, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish_build(name, _start_build(name))
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def current_stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
