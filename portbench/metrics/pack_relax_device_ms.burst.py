"""pack_relax_device_ms.burst: the mean of the cycle entries'
pack_relax_device_ms: the pack arm's LP relaxation (`_relax_part`, every
part's dual ascent), timed on the card by CUDA events around it (absent off
the card)."""
from lib import readers


def read(run):
    return readers.entry_mean(run, "pack_relax_device_ms")
