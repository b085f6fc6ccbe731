"""The device's idle share over the profiler slice of FairGo's finetune:
1 − busy / wall, in %."""


def read(run):
    p = run.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
