"""queue_wait_ms.serve: the median, over the window's requests, of the time
from ``BatchingFrontend.submit`` to the request's hand-over to the engine's
staging (the program's ``frontend.queue`` spans), in ms."""

from harness import program_spans


def read(data):
    return program_spans.median_ms(data, "frontend.queue")
