"""FairGo_GCN's whole pretrain step's share of the chip's peak over the
window: the least time of the window's steps (``counts/fairgo_gcn.py``: the
larger of operations at the float32 peak and bytes at 3.35 TB/s over the
window's sums) over the window's wall, in %."""


def read(run):
    least = run.work.get("least_s", 0.0)
    if least <= 0 or not run.window_s:
        return None
    return 100.0 * least / run.window_s
