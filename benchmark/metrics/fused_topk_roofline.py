"""The kernel's share of its roofline over the profiler slice: the calls'
least time (``counts.topk_call_s``) over the device time of the kernel's
two launches by name (score + select, then merge). Silent unless the kernel
launched once for each request of the slice."""

from harness.trace import kernel_seconds

NAMES = ("score_select", "merge_kernel", "merge_split_kernel")


def read(run):
    work, profile = run.slice_work, run.profile
    if not work or not profile or work.get("requests", 0) <= 0:
        return None
    if work.get("launches") != work["requests"]:
        return None
    device_s = kernel_seconds(profile, *NAMES)
    if device_s <= 0:
        return None
    return 100.0 * work["least_s"] / device_s
