"""warp_roofline: the least time a window's warps could take, from the
bytes they must move (K1's chain heads and key-map resample, K2's chains;
core/counts.py) at the HBM peak, over the device time of the K1 and K2
kernels in the profiled stretch, in percent (kernels: ops/warp_kernels.py,
csrc/warp.cu)."""

from benchmark.core.peaks import PEAK_BYTES_PER_S
from benchmark.core.trace import kernel_time_s

WARP_KERNELS = ("grid_sample_kernel", "warp_chain_")


def read(run):
    s = run.stretch
    if s is None or "warp_bytes" not in run.counters:
        return None
    device_s = kernel_time_s(s, WARP_KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * run.counters["warp_bytes"] / PEAK_BYTES_PER_S / device_s
