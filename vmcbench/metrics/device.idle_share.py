"""Share of the traced epoch in which no operation ran on the device (rank
0's card), in %: 1 - union of the device's operation intervals / epoch."""


def read(run):
    p = run.profile
    if p is None or not p.window_s:
        return None
    return 100 * (1 - p.busy_s / p.window_s)
