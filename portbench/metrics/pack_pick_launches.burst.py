"""pack_pick_launches.burst: the mean of the cycle entries'
pack_pick_launches, the launches of csrc/pack_pick.cu (the rounding's fused
pick, one a rounding round) in the cycle's pack solve: 0 where the pick
runs in plain PyTorch, as it does off the card."""
from lib import readers


def read(run):
    return readers.entry_mean(run, "pack_pick_launches")
