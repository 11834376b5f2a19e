"""device_idle.train: the share of the traced window in which no operation ran
on the device, 1 - (union of device-operation intervals) / window, in %."""


def read(data):
    trace = data["trace"]
    if trace.window_s <= 0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
