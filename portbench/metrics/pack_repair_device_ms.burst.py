"""pack_repair_device_ms.burst: the mean of the cycle entries'
pack_repair_device_ms: the pack arm's repair (the greedy round loop over the
asks the parts stranded), timed on the card by CUDA events around it (absent
off the card)."""
from lib import readers


def read(run):
    return readers.entry_mean(run, "pack_repair_device_ms")
