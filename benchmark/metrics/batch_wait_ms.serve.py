"""batch_wait_ms.serve: the median, over the window's requests, of the time
from staging's take of a request (the end of its ``frontend.queue`` span) to
the start of the ``engine.stage`` span of the batch that carries it (its
``item`` among the batch's ``items``): the wait for a batch to fill, in ms."""

import statistics

from harness import program_spans


def read(data):
    taken = {s.attrs["item"]: s.end for s in program_spans.window_spans(data, "frontend.queue") or []}
    waits = [(stage.start - taken[i]) / 1e6 for stage in program_spans.window_spans(data, "engine.stage") or []
             for i in stage.attrs["items"] if i in taken and taken[i] <= stage.start]
    return statistics.median(waits) if waits else None
