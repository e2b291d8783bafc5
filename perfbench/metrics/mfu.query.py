"""The cosine products of the window's query calls (2 Q d V a call) over
the window's seconds times the card's dense TF32 peak."""

from perfbench import yardstick

UNIT = "%"


def read(record):
    if record.get("kind") != "query" or not record.get("calls"):
        return None
    flops = record["calls"] * yardstick.topk_flops(
        record["block"], record["dim"], record["rows"])
    return 100.0 * flops / (record["window_s"] * yardstick.PEAK_TF32_FLOPS)
