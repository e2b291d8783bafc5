"""Device milliseconds a training step spends in the fused step's
forward kernels (``pair_forward_shared``'s launches and the loss sum):
the program's ``sgns_forward`` stage span, mean over the steps of the
device-only profile (``perfbench/stages.py``; the stage table holds the
whole process, which runs one cell)."""

from perfbench import stages

UNIT = "ms"


def read(record):
    if record.get("kind") != "train":
        return None
    return stages.device_ms(("sgns_forward",), record.get("profiled_steps"))
