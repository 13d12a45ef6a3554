"""kernels layer: % of the memory roofline that kernels A-D reach over the
window: the bytes each recorded call's work needs (read once, written once)
at the card's HBM rate, summed, over their summed device time. Calls with
no kernel on the card count neither bytes nor time; a kernel that no
recorded call launched fails the run."""

from harness import roofline
from harness.trace import kernel_call_times


def read(trace):
    times = kernel_call_times(trace, roofline.KERNEL_NAMES)
    if not times:
        return None
    ns = sum(t for _name, t in times.values())
    nbytes = sum(trace.call_bytes[i][1] for i in times)
    return 100.0 * (nbytes / roofline.HBM_BYTES_PER_S) / (ns / 1e9)
