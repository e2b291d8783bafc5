"""Host milliseconds a training group's dispatch call takes (the packed
loop enqueueing ``steps_per_call`` steps): the median over the window's
groups, on the host clock around each call."""

from perfbench import yardstick

UNIT = "ms"


def read(record):
    if record.get("kind") != "train" or not record.get("dispatch_ms"):
        return None
    return yardstick.median(record["dispatch_ms"])
