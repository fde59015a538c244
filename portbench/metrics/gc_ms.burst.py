"""gc_ms.burst: the interpreter's collector pauses inside the program's
spans over the window (every span's gc_ms summed: the program charges each
pause to the innermost open span of the thread it stopped), per cycle."""
from lib import spans


def read(run):
    if not spans.nested(run):
        return None
    total = sum(float(spans.args(s).get("gc_ms", 0.0)) for s in run.spans)
    return spans.per_cycle(run, total)
