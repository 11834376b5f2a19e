"""g_backward_host_ms.train: the host's time in G's backward (the program's
``train.g_backward`` spans, phases of the window's steps) per step of
the window, in ms."""

from harness import program_spans


def read(data):
    return program_spans.per_step_ms(data, ("train.g_backward",))
