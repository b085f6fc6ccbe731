"""The CSR kernel's share of its roofline over the profiler slice: the least
bytes of the slice's hops at 3.35 TB/s over the device time of the kernels
whose names hold ``spmm_csr`` (the pieces and the rows they share). The hops
are counted from the configuration and the slice's steps, not from the
program's counters, so the share reads the same work whatever implements
it: four full-graph hops a pretrain step, each at its convolution's
narrower width, each source row read once (``counts/fairgo_gcn.py::
hops_work``). None where the slice ran no such kernel."""

from counts import PEAK_BYTES
from harness.trace import kernel_seconds


def read(run):
    work, profile = run.slice_work, run.profile
    if not work or not profile or work.get("hop_bytes", 0) <= 0:
        return None
    device_s = kernel_seconds(profile, "spmm_csr")
    if device_s <= 0:
        return None
    return 100.0 * work["hop_bytes"] / PEAK_BYTES / device_s
