"""The small-tile kernel's share of its roofline: the least chip time of
the completed requests' chains over the device time of the instances of
K1's small-tile kernel alone (both stages of every chain), from the device
trace. A program without that kernel gives nothing."""
from perfbench.readers import least_total_s

KERNEL = "gustavson_small_tile_kernel"


def read(run):
    if run.trace is None:
        return None
    least = least_total_s(run)
    kernel = sum(s for name, s in run.trace.device_s.items() if KERNEL in name)
    if least is None or kernel <= 0:
        return None
    return 100.0 * least / kernel
