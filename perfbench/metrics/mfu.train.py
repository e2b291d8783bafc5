"""Model FLOPs of the window's training pairs (6d for each pair and row
it is scored against) over the window's seconds times the card's dense
TF32 peak."""

from perfbench import yardstick

UNIT = "%"


def read(record):
    if record.get("kind") != "train" or not record.get("pairs"):
        return None
    flops = yardstick.sgns_flops(record["pairs"], record["rows_per_pair"],
                                 record["dim"])
    return 100.0 * flops / (record["window_s"] * yardstick.PEAK_TF32_FLOPS)
