"""Kernel-library runtime: serve the `csrc/*.cu` libraries from the store.

The port runs eager PyTorch and compiles no per-shape program: what a fresh
process compiles is its kernel libraries, the `nvcc` builds that
utils/torchtools makes at a kernel's first use. The runtime hooks into
`torchtools.load_library` / `build_all` and nothing else, and every library
resolves through it: through the one installed (`--aot-store` / conf
solver.aotStore name its directory), else through the process's default,
whose store is `build/kernels/` at the repository root.

  hit   — the kernel's fingerprint resolves to a stored library: it is
          written once, atomically, into the store's `lib/` directory and
          loaded from there. No nvcc runs; the process's first cycle pays a
          file write and a `dlopen`.
  miss  — nvcc builds the library inline (timed into `jit_compile_ms{path}`,
          path = the kernel's name, and a `compile` tracer span), the entry
          is put into the store so the NEXT process hits, and the library
          is loaded from `lib/` as a hit would be.

Each kernel resolves once a process, and its library is loaded once:
`dlopen` caches by path, so two paths of one kernel would give two copies of
its device functions. A library file in `lib/` is never written over: a
process sharing the store (the replay's takeover child, a second scheduler)
may have it mapped.

The fingerprint manifest keys everything that changes the binary: the
kernel name, the sha256 of the source it compiles, the nvcc flags (with
their `-gencode` target), nvcc's release line, the torch and CUDA runtime
versions, and the device's compute capability. A library built for another
target, compiler or runtime fails at launch, not at load, so any change of
these misses the store and builds.

The JAX package's aot/runtime.py, ported. Without a counterpart here:
  - the per-program dispatch and compile (aot_call, aot_compile and their
    spec and leaf signatures): eager torch makes no per-program compile;
  - the background compile, CompilePending and pending_enabled: they serve
    a cycle from a lower tier while the compile runs, and the port has one
    tier by design. conf solver.aotBackground=true is refused
    (`BACKGROUND_REFUSED`); auto and false build inline;
  - bypass and flush: every library resolves through a runtime, and every
    store write is inline.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

from yunikorn_tpu_torch.log.logger import log

logger = log("aot.runtime")

BACKGROUND_REFUSED = (
    "a background build (solver.aotBackground=true) is refused: it would "
    "serve the cycle from a lower tier while the kernel builds, and the "
    "port has one tier (the card); use auto or false, which build inline")

# jit_compile_ms histogram ladder: one nvcc build takes seconds
COMPILE_MS_BUCKETS = (100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                      10000.0, 30000.0, 60000.0, 120000.0)


class AotRuntime:
    def __init__(self, store, *, versions: Optional[Tuple[str, str]] = None,
                 nvcc: Optional[str] = None,
                 capability: Optional[Tuple[int, int]] = None,
                 flags: Optional[Iterable[str]] = None,
                 sources: Optional[Callable[[str], str]] = None,
                 builder: Optional[Callable] = None,
                 loader: Optional[Callable] = None):
        """store: an aot.store.AotStore. versions (torch, CUDA runtime),
        nvcc (its release line), capability (major, minor), flags (the nvcc
        flags) and sources (kernel name -> source digest) are injectable
        for invalidation tests; by default they are read from the live
        install and device when the first kernel resolves. builder(names,
        out_of) builds each named kernel's library into out_of(name) and
        returns {name: ms}; loader(path) loads one library. Both default to
        utils/torchtools' nvcc build and ctypes load."""
        from yunikorn_tpu_torch.utils import torchtools

        self.store = store
        self._versions = versions
        self._nvcc = nvcc
        self._capability = capability
        self._flags = tuple(flags if flags is not None
                            else torchtools.NVCC_FLAGS)
        self._sources = sources or torchtools.source_digest
        self._builder = builder or torchtools.build_libraries
        self._loader = loader or torchtools.load_path
        # the process's one lock of library resolution (torchtools takes it
        # around every runtime call)
        self._mu = torchtools._lock
        self._paths: Dict[str, str] = {}          # kernel -> library path
        self._handles: Dict[str, object] = {}     # kernel -> loaded library
        self.compiles_by_path: Dict[str, int] = {}
        # accounting per namespace ("" outside any): a kernel resolves
        # once a process, under the label of the core (a shard) that
        # needed it first; a namespace changes no key
        self.by_namespace: Dict[str, Dict[str, int]] = {}
        # plain counters: always live, whether or not a registry is attached
        self.hits = 0
        self.misses = 0
        self.compiles = 0
        self.loads = 0
        self._m_hits = self._m_misses = self._h_compile_ms = None
        self._tracer = None
        self._cycle_id_fn: Callable[[], int] = lambda: 0

    # ---------------------------------------------------------------- wiring
    def attach(self, registry=None, tracer=None,
               cycle_id_fn: Optional[Callable[[], int]] = None) -> None:
        """Bind the process's metrics registry / cycle tracer (re-binding to
        a newer core is fine — last writer wins)."""
        if registry is not None:
            self._m_hits = registry.counter(
                "aot_store_hits_total",
                "kernel libraries served from the AOT store with no nvcc "
                "build")
            self._m_misses = registry.counter(
                "aot_store_misses_total",
                "kernel libraries whose fingerprint missed the AOT store, "
                "by kernel", labelnames=("path",))
            self._h_compile_ms = registry.histogram(
                "jit_compile_ms",
                "nvcc build latency of a kernel library the store missed "
                "(ms)", labelnames=("path",), buckets=COMPILE_MS_BUCKETS)
        if tracer is not None:
            self._tracer = tracer
        if cycle_id_fn is not None:
            self._cycle_id_fn = cycle_id_fn

    # ----------------------------------------------------------- fingerprint
    def _versions_sig(self) -> Tuple[str, str]:
        if self._versions is None:
            import torch

            self._versions = (torch.__version__, str(torch.version.cuda))
        return self._versions

    def _nvcc_sig(self) -> str:
        if self._nvcc is None:
            from yunikorn_tpu_torch.utils import torchtools

            self._nvcc = torchtools.nvcc_release()
        return self._nvcc

    def _capability_sig(self) -> str:
        if self._capability is None:
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: the kernel libraries "
                                   "are built for the card's capability")
            self._capability = torch.cuda.get_device_capability()
        return "%d.%d" % tuple(self._capability)

    def manifest(self, path: str) -> dict:
        """The fingerprint of kernel `path`'s library."""
        torch_v, cuda_v = self._versions_sig()
        return {"path": path, "source": self._sources(path),
                "flags": " ".join(self._flags), "nvcc": self._nvcc_sig(),
                "torch": torch_v, "cuda": cuda_v,
                "capability": self._capability_sig()}

    @staticmethod
    def _key(manifest: dict) -> str:
        return hashlib.sha256(repr(sorted(
            (k, str(v)) for k, v in manifest.items()
        )).encode()).hexdigest()[:24]

    # -------------------------------------------------------------- dispatch
    def resolve(self, names: Iterable[str]) -> Dict[str, str]:
        """Each named kernel's library path: a stored library (hit), or one
        nvcc builds now (miss; every missing kernel's build started
        together) and puts into the store. Memoized: a kernel resolves once
        a process. Raises when a build fails."""
        names = list(names)
        with self._mu:
            todo = []
            for name in names:
                if name in self._paths:
                    continue
                manifest = self.manifest(name)
                key = self._key(manifest)
                path = self._load(name, key)
                if path is not None:
                    self._paths[name] = path
                    self._count("hits", name)
                else:
                    self._count("misses", name)
                    todo.append((name, key, manifest))
            if todo:
                self._build(todo)
            return {name: self._paths[name] for name in names}

    def load(self, name: str):
        """The loaded library of kernel `name` (resolved, then loaded once
        a process)."""
        with self._mu:
            lib = self._handles.get(name)
            if lib is None:
                path = self.resolve([name])[name]
                lib = self._handles[name] = self._loader(path)
                self.loads += 1
            return lib

    # ------------------------------------------------------------- internals
    def _lib_path(self, name: str, key: str) -> str:
        return os.path.join(self.store.lib_dir, f"lib{name}-{key}.so")

    def _load(self, name: str, key: str) -> Optional[str]:
        """The stored library of (name, key) written into lib/ (once: an
        existing file is the same bytes, and may be mapped), or None on a
        miss. A corrupt entry reads as a miss (the store quarantines it)."""
        rec = self.store.get(name, key)
        if rec is None:
            return None
        path = self._lib_path(name, key)
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "wb") as f:
                f.write(rec[1])
            os.replace(tmp, path)
        logger.info("aot: %s (%s) served from the store", name, key)
        return path

    def _build(self, todo) -> None:
        built = {name: f"{self._lib_path(name, key)}.build-{os.getpid()}"
                 for name, key, _ in todo}
        t0 = time.time()
        ms = self._builder([name for name, _, _ in todo],
                           lambda name: Path(built[name]))
        for name, key, manifest in todo:
            self._save(name, key, manifest, built[name], ms[name], t0)

    def _save(self, name: str, key: str, manifest: dict, built: str,
              ms: float, t0: float) -> None:
        """Put a fresh build into the store and move it into lib/ (unless
        a file of that key is there already: the same bytes, maybe mapped)."""
        with open(built, "rb") as f:
            payload = f.read()
        self.store.put(name, key, manifest, payload)
        path = self._lib_path(name, key)
        if os.path.exists(path):
            os.unlink(built)
        else:
            os.replace(built, path)
        self._paths[name] = path
        self.compiles += 1
        self.compiles_by_path[name] = self.compiles_by_path.get(name, 0) + 1
        if self._h_compile_ms is not None:
            self._h_compile_ms.observe(ms, path=name)
        if self._tracer is not None:
            try:
                self._tracer.add("compile", self._cycle_id_fn(), t0,
                                 t0 + ms / 1000, path=name, key=key)
            except Exception:
                pass
        logger.info("aot: built %s (%s) in %.0f ms and stored it", name,
                    key, ms)

    def _count(self, kind: str, name: str) -> None:
        from yunikorn_tpu_torch.utils import torchtools

        setattr(self, kind, getattr(self, kind) + 1)
        if kind == "hits":
            torchtools.kernel_stats["hits"] += 1    # under self._mu
        ns = getattr(_tls, "namespace", None) or ""
        acc = self.by_namespace.setdefault(ns, {"hits": 0, "misses": 0})
        acc[kind] += 1
        if kind == "hits" and self._m_hits is not None:
            self._m_hits.inc()
        if kind == "misses" and self._m_misses is not None:
            self._m_misses.inc(path=name)

    def stats(self) -> dict:
        with self._mu:
            out = {"hits": self.hits, "misses": self.misses,
                   "compiles": self.compiles, "loads": self.loads,
                   "namespaces": {k: dict(v)
                                  for k, v in self.by_namespace.items()}}
        if self.store is not None:
            out["store"] = self.store.stats()
        return out


# ---------------------------------------------------------------- singleton
# One process-wide runtime: utils/torchtools consults it through active().
# Installed by cmd/scheduler.py, cmd/trace_replay.py, cmd/aot_build.py,
# cmd/aot_smoke.py or a test; without one, the default runtime on
# build/kernels/ serves.
_runtime: Optional[AotRuntime] = None
_default: Optional[AotRuntime] = None
_tls = threading.local()
_mu = threading.Lock()


def get_runtime() -> Optional[AotRuntime]:
    """The installed runtime (None when none is)."""
    return _runtime


def set_runtime(rt: Optional[AotRuntime]) -> Optional[AotRuntime]:
    global _runtime
    prev, _runtime = _runtime, rt
    return prev


def active() -> AotRuntime:
    """The runtime kernel libraries resolve through: the installed one,
    else the process's default, whose store is utils/torchtools.BUILD_DIR
    (made at its first use)."""
    global _default
    if _runtime is not None:
        return _runtime
    with _mu:
        if _default is None:
            from yunikorn_tpu_torch.aot.store import AotStore
            from yunikorn_tpu_torch.utils import torchtools

            _default = AotRuntime(AotStore(str(torchtools.BUILD_DIR)))
        return _default


class namespace:
    """Context manager: account every kernel resolution inside the block
    under `ns` (a shard's label, core/shard.py). Thread-local: each shard
    resolves its kernels on its own thread. It labels the runtime's
    accounting and changes no key: a library is per process, and every
    shard loads the same one."""

    def __init__(self, ns: Optional[str]):
        self._ns = ns

    def __enter__(self):
        self._prev = getattr(_tls, "namespace", None)
        _tls.namespace = self._ns
        return self

    def __exit__(self, *exc):
        _tls.namespace = self._prev
        return False


def install(store_path: str, *, max_bytes: int = 0, **kwargs) -> AotRuntime:
    """Create store + runtime at store_path and install it as the process
    singleton (kwargs go to AotRuntime)."""
    from yunikorn_tpu_torch.aot.store import AotStore

    rt = AotRuntime(AotStore(store_path, max_bytes=max_bytes), **kwargs)
    set_runtime(rt)
    return rt


def compile_count(*prefixes: str) -> int:
    """nvcc builds this process ran, of the kernels whose name starts with
    any prefix (all without one)."""
    from yunikorn_tpu_torch.utils import torchtools

    with torchtools._lock:
        return sum(n for name, n in torchtools.build_counts.items()
                   if not prefixes or name.startswith(prefixes))
