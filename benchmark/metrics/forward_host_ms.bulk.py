"""forward_host_ms.bulk: the median of the program's ``dehazeformer.forward``
spans (inside ``engine.dispatch``) over the window's batches, in ms: the
host's time to enqueue one batch's forward. Where the device is the
bottleneck, as in ``dehazeformer_b.bulk.620x460``, the forward's launches
fill CUDA's launch queue and the span ends only as the device drains it,
so it reads the device's pace, near the batch's device time, and not the
host's cost."""

from harness import program_spans


def read(data):
    return program_spans.median_ms(data, "dehazeformer.forward")
