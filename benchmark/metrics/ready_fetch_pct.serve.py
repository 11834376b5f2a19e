"""ready_fetch_pct.serve: the share, in %, of the window's fetches that
``InferenceEngine.stream`` made because the batch's result was already back
when it asked (the program's ``engine.fetch`` spans with ``why`` "ready"),
not by waiting on a batch still running."""

from harness import program_spans


def read(data):
    return program_spans.share_pct(data, "engine.fetch", "why", "ready")
