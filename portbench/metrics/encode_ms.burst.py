"""encode_ms.burst: the mean per cycle of the core tracer's "encode" spans
(program spans) over the window."""
from lib import readers


def read(run):
    return readers.span_ms_per_cycle(run, "encode")
