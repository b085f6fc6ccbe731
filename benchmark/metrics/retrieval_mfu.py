"""The whole request's share of the chip's peak over the window: each
request's least time (``counts.topk_call_s``: 2·B·I·d operations at the
bfloat16 peak, or the tables' bytes and the answer at 3.35 TB/s, whichever
is larger) summed, over the window's wall, in %."""


def read(run):
    least = run.work.get("least_s", 0.0)
    if least <= 0 or not run.window_s:
        return None
    return 100.0 * least / run.window_s
