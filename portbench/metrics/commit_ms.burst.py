"""commit_ms.burst: the mean per cycle of the core tracer's "commit" and
"publish" spans together over the window."""
from lib import readers


def read(run):
    return readers.span_ms_per_cycle(run, "commit", "publish")
