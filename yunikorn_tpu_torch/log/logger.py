"""Hierarchical, hot-reloadable component loggers.

Role-equivalent to the reference's pkg/log/logger.go: 26 named loggers (:55-92),
per-logger levels resolved from config keys ``log.<name>.level`` with dotted-parent
inheritance (:139-161), and an atomic swap of the logging config on hot reload
(:217-285). Built on the stdlib ``logging`` module; the "filtered core" trick
(filtered_core.go) maps onto per-logger level caps.
"""
from __future__ import annotations

import logging
import sys
from typing import Dict, Optional

from yunikorn_tpu_torch.locking import locking

_ROOT_NAME = "yunikorn"

# The named logger handles (reference logger.go:55-92 defines the analogous set).
HANDLES = [
    "admission",
    "admission.client",
    "admission.conf",
    "admission.utils",
    "admission.webhook",
    "core",
    "core.config",
    "core.scheduler",
    "core.placement",
    "core.queue",
    "deprecation",
    "dispatcher",
    "kubernetes",
    "rmproxy",
    "shim",
    "shim.cache.application",
    "shim.cache.context",
    "shim.cache.external",
    "shim.cache.node",
    "shim.cache.placeholder",
    "shim.cache.task",
    "shim.client",
    "shim.config",
    "shim.context",
    "shim.dispatcher",
    "shim.fsm",
    "shim.predicates",
    "shim.resources",
    "shim.scheduler",
    "shim.snapshot",
    "shim.solver",
    "shim.utils",
    "test",
]

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "dpanic": logging.CRITICAL,
    "panic": logging.CRITICAL,
    "fatal": logging.CRITICAL,
    # zap also accepts numeric levels -1..5
    "-1": logging.DEBUG,
    "0": logging.INFO,
    "1": logging.WARNING,
    "2": logging.ERROR,
    "3": logging.CRITICAL,
    "4": logging.CRITICAL,
    "5": logging.CRITICAL,
}

_lock = locking.Mutex()
_configured = False
_current_config: Dict[str, str] = {}


def _ensure_configured() -> None:
    global _configured
    if _configured:
        return
    with _lock:
        if _configured:
            return
        root = logging.getLogger(_ROOT_NAME)
        if not root.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(
                logging.Formatter(
                    fmt="%(asctime)s %(levelname)s %(name)s %(message)s",
                    datefmt="%Y-%m-%dT%H:%M:%S",
                )
            )
            root.addHandler(h)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True


def log(handle: str = "shim") -> logging.Logger:
    """Return the named component logger (reference: log.Log(handle), logger.go:108)."""
    _ensure_configured()
    return logging.getLogger(f"{_ROOT_NAME}.{handle}")


def resolve_level(handle: str, config: Dict[str, str]) -> Optional[int]:
    """Resolve ``log.<handle>.level`` with dotted-parent inheritance.

    ``log.shim.cache.task.level`` falls back to ``log.shim.cache.level`` →
    ``log.shim.level`` → ``log.level`` (reference logger.go:139-161).
    """
    parts = handle.split(".")
    while parts:
        key = "log." + ".".join(parts) + ".level"
        if key in config:
            return _LEVELS.get(config[key].strip().lower())
        parts.pop()
    if "log.level" in config:
        return _LEVELS.get(config["log.level"].strip().lower())
    return None


def update_logging_config(config: Dict[str, str]) -> None:
    """Atomically apply per-logger levels from a flattened configmap.

    Unknown level strings are ignored (the reference warns and keeps the old
    level). Called on config hot-reload (reference logger.go:217-285).
    """
    _ensure_configured()
    with _lock:
        global _current_config
        _current_config = dict(config)
        root_level = resolve_level("", config)
        root = logging.getLogger(_ROOT_NAME)
        root.setLevel(root_level if root_level is not None else logging.INFO)
        for handle in HANDLES:
            lvl = resolve_level(handle, config)
            lg = logging.getLogger(f"{_ROOT_NAME}.{handle}")
            # NOTSET => inherit from parent, matching dotted inheritance.
            lg.setLevel(lvl if lvl is not None else logging.NOTSET)


def current_config() -> Dict[str, str]:
    with _lock:
        return dict(_current_config)
