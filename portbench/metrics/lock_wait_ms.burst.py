"""lock_wait_ms.burst: the mean per cycle of the cycle thread's waits for
the core lock while another thread held it (the program's "lock_wait"
spans under its gate, dispatch, commit and housekeeping spans)."""
from lib import spans


def read(run):
    if not spans.nested(run):
        return None
    total = sum(spans.wall_ms(s) for s in run.spans
                if s.name == "lock_wait" and s.parent in spans.LOCK_STAGES)
    return spans.per_cycle(run, total)
