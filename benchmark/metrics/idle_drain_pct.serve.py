"""idle_drain_pct.serve: the share, in %, of the window's fetches that
``InferenceEngine.stream`` made because its input was quiet for about
``max_wait`` (the program's ``engine.fetch`` spans with ``why`` "idle"),
not because more than ``depth`` batches were in flight."""

from harness import program_spans


def read(data):
    return program_spans.share_pct(data, "engine.fetch", "why", "idle")
