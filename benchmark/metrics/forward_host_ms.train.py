"""forward_host_ms.train: the host's time in the forwards and their losses
per step of the window (the program's ``train.g_forward``, ``train.g_loss``
and ``train.d_forward`` spans, phases of the window's steps), in ms."""

from harness import program_spans


def read(data):
    return program_spans.per_step_ms(data, ("train.g_forward", "train.g_loss", "train.d_forward"))
