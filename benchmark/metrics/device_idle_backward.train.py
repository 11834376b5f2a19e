"""device_idle_backward.train: the share of the traced window, in %, in which
no operation ran on the device and the host was in a backward (inside the
program's ``train.g_backward`` or ``train.d_backward`` spans)."""

from harness import program_spans


def read(data):
    return program_spans.idle_inside_pct(data, ("train.g_backward", "train.d_backward"))
