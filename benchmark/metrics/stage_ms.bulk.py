"""stage_ms.bulk: the host's mean time to stage a batch (the padding, the
ladder rung's fill and the stack: the program's ``engine.stage`` spans) over
the window's batches, in ms."""

from harness import program_spans


def read(data):
    return program_spans.mean_ms(data, "engine.stage")
