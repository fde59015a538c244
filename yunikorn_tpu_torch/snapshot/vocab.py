"""Vocabularies: mapping symbolic cluster state onto fixed tensor shapes.

The hard part of putting a K8s-class scheduler on a TPU (SURVEY.md §7 "hard
parts") is that predicates are symbolic — label selectors, taints, resource
names — while XLA wants fixed shapes. The resolution here:

  - **ResourceVocab**: resource names → column slots of the [*, R] resource
    matrices, each with a scale divisor chosen so quantities stay inside
    float32's exact-integer range (cpu → millicores, memory → MiB, ...).
  - **BitVocab**: interned symbols → bit positions in [*, W] uint32 bitsets.
    Used for label (key,value) pairs, taint (key,value,effect) triples and
    host ports. For every (key,value) label bit we also intern a (key,*) bit
    so Exists/DoesNotExist operators become plain mask tests.

Vocab growth changes W/R and forces an XLA recompile, so sizes grow in
power-of-two buckets and stay sticky (a recompile happens at most log2 times
per dimension over a cluster's life).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from yunikorn_tpu_torch.locking import locking
from yunikorn_tpu_torch.common.resource import CPU, EPHEMERAL_STORAGE, MEMORY, PODS

WORD_BITS = 32


def _next_pow2(n: int, minimum: int) -> int:
    v = minimum
    while v < n:
        v *= 2
    return v


class ResourceVocab:
    """Resource name → (slot, scale). Slots 0..3 are pinned well-known resources."""

    PINNED: List[Tuple[str, int]] = [
        (CPU, 1),                      # already millicores
        (MEMORY, 2**20),               # bytes → MiB
        (PODS, 1),
        (EPHEMERAL_STORAGE, 2**20),    # bytes → MiB
    ]

    def __init__(self, min_slots: int = 8):
        self._lock = locking.Mutex()
        self._slots: Dict[str, int] = {}
        self._scales: Dict[str, int] = {}
        self._min_slots = min_slots
        for name, scale in self.PINNED:
            self._slots[name] = len(self._slots)
            self._scales[name] = scale

    def slot(self, name: str) -> int:
        with self._lock:
            idx = self._slots.get(name)
            if idx is None:
                idx = len(self._slots)
                self._slots[name] = idx
                self._scales[name] = 1
            return idx

    def scale(self, name: str) -> int:
        with self._lock:
            return self._scales.get(name, 1)

    def quantize(self, name: str, value: int) -> float:
        """Host value → device units (ceil for requests is the caller's choice)."""
        return value / self.scale(name)

    @property
    def num_slots(self) -> int:
        """Padded slot count (the R dimension)."""
        with self._lock:
            return _next_pow2(len(self._slots), self._min_slots)

    def used_slots(self) -> int:
        with self._lock:
            return len(self._slots)

    def items(self) -> List[Tuple[str, int, int]]:
        with self._lock:
            return [(n, i, self._scales[n]) for n, i in self._slots.items()]


class BitVocab:
    """Interned symbols → bit positions; exposes word count W (padded)."""

    def __init__(self, min_words: int = 4):
        self._lock = locking.Mutex()
        self._bits: Dict[object, int] = {}
        self._min_words = min_words

    def bit(self, symbol: object) -> int:
        with self._lock:
            idx = self._bits.get(symbol)
            if idx is None:
                idx = len(self._bits)
                self._bits[symbol] = idx
            return idx

    def lookup(self, symbol: object) -> int:
        """Like bit() but returns -1 instead of interning unknown symbols."""
        with self._lock:
            return self._bits.get(symbol, -1)

    @property
    def num_words(self) -> int:
        with self._lock:
            return _next_pow2(max(1, (len(self._bits) + WORD_BITS - 1) // WORD_BITS), self._min_words)

    def used_bits(self) -> int:
        with self._lock:
            return len(self._bits)

    def symbols(self) -> List[Tuple[object, int]]:
        with self._lock:
            return list(self._bits.items())


# Symbol constructors -------------------------------------------------------

ANY = "*"


def label_bit(key: str, value: str) -> Tuple[str, str, str]:
    return ("label", key, value)


def label_key_bit(key: str) -> Tuple[str, str, str]:
    """The (key, *) presence bit backing Exists/DoesNotExist."""
    return ("label", key, ANY)


def taint_bit(key: str, value: str, effect: str) -> Tuple[str, str, str, str]:
    return ("taint", key, value, effect)


def port_bit(protocol: str, port: int) -> Tuple[str, str, int]:
    return ("port", protocol or "TCP", port)


class Vocabs:
    """The bundle a snapshot encoder works against."""

    def __init__(self):
        self.resources = ResourceVocab()
        self.labels = BitVocab()
        self.taints = BitVocab()
        self.ports = BitVocab()
