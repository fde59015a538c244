"""pack_round_device_ms.burst: the mean of the cycle entries'
pack_round_device_ms: the pack arm's randomized rounding (`_round_part`, its
Gumbel draws included), timed on the card by CUDA events around it (absent
off the card)."""
from lib import readers


def read(run):
    return readers.entry_mean(run, "pack_round_device_ms")
