"""fetch_ms.serve: the median, over the window's batches, of the time
``InferenceEngine.stream`` takes to fetch a batch asked for: the wait on
its result's copy and the copy of its crops out (the program's
``engine.fetch`` spans), in ms."""

from harness import program_spans


def read(data):
    return program_spans.median_ms(data, "engine.fetch")
