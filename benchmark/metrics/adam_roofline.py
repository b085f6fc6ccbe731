"""Dense Adam's share of its roofline over the profiler slice: the bytes
it needs (the parameter and both moments read and written once, 6 × params
× 4 B a step, ``counts.adam_bytes``) at 3.35 TB/s, over the device time of
the kernels named for Adam."""

from counts import PEAK_BYTES
from harness.trace import kernel_seconds


def read(run):
    work, profile = run.slice_work, run.profile
    if not work or not profile or work.get("adam_bytes", 0) <= 0:
        return None
    device_s = kernel_seconds(profile, "adam")
    if device_s <= 0:
        return None
    return 100.0 * work["adam_bytes"] / PEAK_BYTES / device_s
