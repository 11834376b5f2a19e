"""k1_roofline.bulk: K1's least time over its device time in the traced
window, in %. The least time of a launch is the larger of its operations
over the bf16 peak and its bytes over the memory bandwidth, averaged over
the configuration's dense layers at the (batch, H, W) the window runs the
model at (``launch_shape``; harness/counts.py::k1_mean_bound_s); K1's
launches are the device kernels whose names match PATTERN."""

from harness import counts

PATTERN = r"dense_layer_"


def read(data):
    trace, shape = data["trace"], data.get("launch_shape")
    n, seconds = trace.count(PATTERN), trace.seconds(PATTERN)
    if not shape or not n or seconds <= 0:
        return None
    return 100.0 * n * counts.k1_mean_bound_s(data["config"], shape) / seconds
