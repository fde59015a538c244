"""gate_self_ms.burst: the mean per cycle of the program's "gate" span less
what its children cover: the waits for the core lock ("lock_wait") and
the collector's pauses (the gc_ms of the gate and of its descendants)."""
from lib import spans


def read(run):
    if not spans.nested(run):
        return None
    total = 0.0
    for g in run.spans:
        if g.name != "gate":
            continue
        inner = spans.children(run, g)
        for s in list(inner):
            inner.extend(spans.children(run, s))
        total += (spans.wall_ms(g)
                  - sum(spans.wall_ms(s) for s in inner
                        if s.name == "lock_wait")
                  - sum(float(spans.args(s).get("gc_ms", 0.0))
                        for s in [g] + inner))
    return spans.per_cycle(run, total)
