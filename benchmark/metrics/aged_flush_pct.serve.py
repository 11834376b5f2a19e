"""aged_flush_pct.serve: the share, in %, of the window's batches that
staging flushed below the top of the ladder because their oldest image had
waited ``max_wait`` (the program's ``engine.stage`` spans with ``why``
"aged")."""

from harness import program_spans


def read(data):
    return program_spans.share_pct(data, "engine.stage", "why", "aged")
