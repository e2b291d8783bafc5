"""Device milliseconds a training step spends packing its pairs and
drawing its negatives: the program's ``pack_pairs`` and ``draw_negatives``
stage spans, mean over the steps of the device-only profile
(``perfbench/stages.py``; the stage table holds the whole process, which
runs one cell)."""

from perfbench import stages

UNIT = "ms"


def read(record):
    if record.get("kind") != "train":
        return None
    return stages.device_ms(("pack_pairs", "draw_negatives"),
                            record.get("profiled_steps"))
