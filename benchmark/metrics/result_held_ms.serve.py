"""result_held_ms.serve: the median, over the window's batches, of the time
a dispatched batch sits in ``InferenceEngine.stream``'s in-flight queue,
from the end of its dispatch to the start of its fetch (the program's
``engine.held`` spans), in ms."""

from harness import program_spans


def read(data):
    return program_spans.median_ms(data, "engine.held")
