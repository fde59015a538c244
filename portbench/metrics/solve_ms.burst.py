"""solve_ms.burst: the mean per cycle of the core tracer's "dispatch"
spans over the window. In the port the greedy solve runs to its end
inside the dispatch (and the duel arms are launched there); the tracer's
"solve" span runs from the dispatch's end to the next tick's read-back and
holds no solve work."""
from lib import readers


def read(run):
    return readers.span_ms_per_cycle(run, "dispatch")
