"""The whole train step's share of the chip's peak over the window: the
steps' least time (``counts/``: the larger of operations at the peak and
bytes at 3.35 TB/s, each step) summed, over the window's wall, in %."""


def read(run):
    least = run.work.get("least_s", 0.0)
    if least <= 0 or not run.window_s:
        return None
    return 100.0 * least / run.window_s
