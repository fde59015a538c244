"""On-disk kernel-library store: the built `csrc/*.cu` libraries per
fingerprint.

The cold-start cost this removes: a new scheduler process that finds no
library for the current source runs `nvcc` on every kernel inside its first
cycle's runtime resolution (seconds a kernel). The port runs eager PyTorch:
the only things it compiles are its kernel libraries, so the store keeps
those, written once by an offline builder (cmd/aot_build.py) or by the first
process that built them, and loaded by every later process in milliseconds.

Store layout (one directory):

  entries/<kernel>-<key>.aotx  one library: MAGIC + sha256(body) + body,
                               body = pickle of {"manifest", "payload"},
                               payload = the library's .so bytes
  entries/<kernel>-<key>.json  human-readable manifest sidecar (debugging;
                               best-effort, never load-bearing)
  quarantine/                  corrupt/truncated entries moved here on read
                               failure — a bad entry reads as a miss, and the
                               caller builds the kernel again
  lib/                         the libraries the runtime loads, written once
                               each (aot/runtime.py)

The magic differs from the JAX package's executable store, so an entry of
one is never read as an entry of the other. That store's `xla_cache/` mirror
and its save/restore of the persistent compilation cache have no
counterpart: the entries are the libraries themselves.

Durability discipline: writes are atomic (tmp file + os.replace in the same
directory), reads verify magic + digest before unpickling, and the total
entry size is LRU-capped (mtime refreshed on every hit; oldest entries
evicted past `max_bytes`). A failed write is logged and returns False; the
caller keeps the library it built.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import tempfile
import time
from typing import Optional, Tuple

from yunikorn_tpu_torch.log.logger import log

logger = log("aot.store")

_MAGIC = b"YKTLIB1\n"
_DIGEST_LEN = 32

# default LRU size cap for the entries/ directory (env-overridable by the
# binaries that construct the store)
DEFAULT_MAX_BYTES = 4 << 30


def _safe_name(path: str) -> str:
    return "".join(c if (c.isalnum() or c in "._-") else "_" for c in path)


class AotStore:
    """Filesystem-backed library store. Safe for concurrent processes
    sharing one directory: every mutation is an atomic rename and readers
    verify integrity, so the worst race outcome is a miss."""

    def __init__(self, root: str, max_bytes: int = 0):
        self.root = os.path.abspath(root)
        self.entries_dir = os.path.join(self.root, "entries")
        self.quarantine_dir = os.path.join(self.root, "quarantine")
        self.lib_dir = os.path.join(self.root, "lib")
        self.max_bytes = int(max_bytes) if max_bytes else int(
            os.environ.get("YK_AOT_STORE_MAX_BYTES", DEFAULT_MAX_BYTES))
        for d in (self.entries_dir, self.quarantine_dir, self.lib_dir):
            os.makedirs(d, exist_ok=True)
        # counters surfaced through AotRuntime.stats()
        self.corrupt_quarantined = 0
        self.evicted = 0

    # ------------------------------------------------------------ entry I/O
    def _entry_path(self, path: str, key: str) -> str:
        return os.path.join(self.entries_dir, f"{_safe_name(path)}-{key}.aotx")

    def get(self, path: str, key: str) -> Optional[Tuple[dict, bytes]]:
        """Read + verify one entry. Returns (manifest, payload) or None
        (missing OR corrupt — corrupt entries are moved to quarantine/ so
        they cannot poison later processes)."""
        fp = self._entry_path(path, key)
        try:
            with open(fp, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        try:
            if (len(blob) < len(_MAGIC) + _DIGEST_LEN
                    or not blob.startswith(_MAGIC)):
                raise ValueError("bad magic/truncated header")
            digest = blob[len(_MAGIC):len(_MAGIC) + _DIGEST_LEN]
            body = blob[len(_MAGIC) + _DIGEST_LEN:]
            if hashlib.sha256(body).digest() != digest:
                raise ValueError("digest mismatch (truncated or bit-rotted)")
            rec = pickle.loads(body)
            manifest = rec["manifest"]
            payload = rec["payload"]
        except Exception as e:
            self._quarantine(fp, reason=f"{type(e).__name__}: {e}")
            return None
        try:  # refresh LRU recency on hit; never load-bearing
            now = time.time()
            os.utime(fp, (now, now))
        except OSError:
            pass
        return manifest, payload

    def put(self, path: str, key: str, manifest: dict, payload: bytes) -> bool:
        """Atomically write one entry (+ manifest sidecar), then enforce the
        LRU size cap. Returns False on any I/O failure (logged, swallowed —
        the library still lives where the caller built it)."""
        fp = self._entry_path(path, key)
        body = pickle.dumps({"manifest": manifest, "payload": payload},
                            protocol=pickle.HIGHEST_PROTOCOL)
        blob = _MAGIC + hashlib.sha256(body).digest() + body
        try:
            fd, tmp = tempfile.mkstemp(dir=self.entries_dir, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(blob)
                os.replace(tmp, fp)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            with open(fp[:-5] + ".json", "w") as f:
                json.dump({"manifest": manifest, "bytes": len(blob),
                           "written_at": time.time()}, f, indent=1,
                          default=str)
        except Exception:
            logger.exception("aot store write failed for %s", fp)
            return False
        self._enforce_cap()
        return True

    def _quarantine(self, fp: str, reason: str) -> None:
        base = os.path.basename(fp)
        dst = os.path.join(self.quarantine_dir, f"{base}.{int(time.time())}")
        try:
            os.replace(fp, dst)
        except OSError:
            try:  # cross-device or permission trouble: drop it instead
                os.unlink(fp)
                dst = "(deleted)"
            except OSError:
                return
        self.corrupt_quarantined += 1
        logger.warning("aot store entry %s is corrupt (%s); quarantined to "
                       "%s — the caller will build the kernel", base, reason,
                       dst)

    def _enforce_cap(self) -> None:
        """Evict oldest-mtime entries until the total is under max_bytes."""
        try:
            items = []
            total = 0
            for name in os.listdir(self.entries_dir):
                if not name.endswith(".aotx"):
                    continue
                fp = os.path.join(self.entries_dir, name)
                try:
                    st = os.stat(fp)
                except OSError:
                    continue
                items.append((st.st_mtime, st.st_size, fp))
                total += st.st_size
            if total <= self.max_bytes:
                return
            for _, size, fp in sorted(items):
                try:
                    os.unlink(fp)
                    try:
                        os.unlink(fp[:-5] + ".json")
                    except OSError:
                        pass
                except OSError:
                    continue
                self.evicted += 1
                total -= size
                logger.info("aot store evicted %s (LRU size cap %d bytes)",
                            os.path.basename(fp), self.max_bytes)
                if total <= self.max_bytes:
                    return
        except Exception:
            logger.exception("aot store LRU enforcement failed")

    # -------------------------------------------------------- introspection
    def entry_count(self) -> int:
        try:
            return sum(1 for n in os.listdir(self.entries_dir)
                       if n.endswith(".aotx"))
        except OSError:
            return 0

    def stats(self) -> dict:
        return {"root": self.root, "entries": self.entry_count(),
                "quarantined": self.corrupt_quarantined,
                "evicted": self.evicted}
