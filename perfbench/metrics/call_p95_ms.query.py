"""Host milliseconds of one query call (the block's pull and
``find_synonyms_batch``), the 95th percentile over the window's timed
calls."""

from perfbench import yardstick

UNIT = "ms"


def read(record):
    if record.get("kind") != "query" or not record.get("call_ms"):
        return None
    return yardstick.percentile(record["call_ms"], 95)
