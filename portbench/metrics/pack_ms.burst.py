"""pack_ms.burst: the mean of the core's pack_plan_ms (the pack arm's
dispatch to the duel's decision) over the window's cycles in which the
arm ran."""
from lib import readers


def read(run):
    return readers.entry_mean(run, "pack_plan_ms")
