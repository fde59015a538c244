"""gumbel_device_ms.burst: the mean of the cycle entries'
pack_gumbel_device_ms, the pack arm's Gumbel draws (utils/prng's
counter-based hash, one a rounding round) timed on the card by CUDA events
around each and summed over the rounds (absent off the card)."""
from lib import readers


def read(run):
    return readers.entry_mean(run, "pack_gumbel_device_ms")
