"""latency_p50_ms.serve: the median, over every request due in the window,
of the time from its due time to its result."""


def read(data):
    return data.get("latency_p50_ms")
