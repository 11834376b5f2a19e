"""wattn_roofline.bulk: the window attention kernel's least time over its
device time in the traced window, in %. The least time of a launch is the
larger of its operations over the bf16 peak and its bytes over the memory
bandwidth (4·64·C operations a padded token; QK and V read and O written
once a real pixel in bf16), averaged over the configuration's attending
blocks at the (batch, H, W) the window serves (``launch_shape``; the model
family's ``wattn_mean_bound_s``); the kernel's launches are the device
kernels whose names match PATTERN. None where the family has no such count
or the window ran no such kernel."""

PATTERN = r"window_attention_kernel"


def read(data):
    trace, shape = data["trace"], data.get("launch_shape")
    bound = getattr(data.get("family"), "wattn_mean_bound_s", None)
    n, seconds = trace.count(PATTERN), trace.seconds(PATTERN)
    if bound is None or not shape or not n or seconds <= 0:
        return None
    return 100.0 * n * bound(data["config"], shape) / seconds
