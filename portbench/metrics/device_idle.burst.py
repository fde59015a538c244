"""The share of the profiled stretch in which no device operation was
running: one minus the union of the device's intervals over the stretch
(torch.profiler's trace)."""
from lib import readers


def read(run):
    return readers.idle_percent(run)
