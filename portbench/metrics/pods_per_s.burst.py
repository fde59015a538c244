"""pods_per_s.burst: every pod placed in the window over the window's
seconds (host clock; the window holds whole waves). Read in the traced run,
whose profiler covers the window's first two waves."""


def read(run):
    placed = run.notes.get("placed_in_window")
    if placed is None or run.t1 <= run.t0:
        return None
    return placed / (run.t1 - run.t0)
