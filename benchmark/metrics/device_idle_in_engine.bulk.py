"""device_idle_in_engine.bulk: the share of the traced window, in %, in which
no operation ran on the device and the host was staging or dispatching a
batch (inside the program's ``engine.stage`` or ``engine.dispatch``
spans)."""

from harness import program_spans


def read(data):
    return program_spans.idle_inside_pct(data, ("engine.stage", "engine.dispatch"))
