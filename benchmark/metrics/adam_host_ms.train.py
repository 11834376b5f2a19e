"""adam_host_ms.train: the host's time in the optimiser updates per step of
the window (the program's ``train.g_adam``, ``train.bn_fold`` and
``train.d_adam`` spans, phases of the window's steps: both Adams and the
fold of G's batch statistics), in ms."""

from harness import program_spans


def read(data):
    return program_spans.per_step_ms(data, ("train.g_adam", "train.bn_fold", "train.d_adam"))
