"""si_update_ms.burst: the mean per wave of the program's "si_update"
spans, each the whole of one update_allocation at the SI boundary (the
wave's asks and the release of the wave before, ingested under the core
lock on the caller's thread)."""
from lib import spans


def read(run):
    ups = [s for s in run.spans if s.name == "si_update"]
    waves = sum(1 for s in ups if spans.args(s).get("asks"))
    if not waves:
        return None
    return sum(spans.wall_ms(s) for s in ups) / waves
