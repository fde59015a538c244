"""device_ms_per_kpod: the card's busy time over the window (the union of
its operations' intervals in a profile of the device alone), in ms, per
1,000 pods placed in the window."""


def read(run):
    p = run.window_profile
    placed = run.notes.get("placed_in_window")
    if p is None or not p.ops or not placed:
        return None
    return p.busy_s * 1e3 / (placed / 1e3)
