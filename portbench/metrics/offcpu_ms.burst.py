"""offcpu_ms.burst: the mean per cycle, over the program's gate, encode,
housekeeping, commit, publish and si_update spans, of wall time less the
thread's CPU time less their core-lock waits: time runnable but not
running (the interpreter lock held by another thread, or the shared core
taken away)."""
from lib import spans


def read(run):
    if not spans.nested(run):
        return None
    total = 0.0
    for s in run.spans:
        if s.name not in spans.OFFCPU_STAGES:
            continue
        waits = spans.children(run, s, ("lock_wait",))
        total += spans.offcpu_ms(s) - sum(spans.offcpu_ms(w) for w in waits)
    return spans.per_cycle(run, total)
