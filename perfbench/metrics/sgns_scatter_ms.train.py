"""Device milliseconds a training step spends in the fused step's
scatters (``scatter_add_rank1_hbm``, ``scatter_add_rows_f32`` and their id
sorts): the program's ``sgns_scatter`` stage span, mean over the steps of
the device-only profile (``perfbench/stages.py``; the stage table holds
the whole process, which runs one cell)."""

from perfbench import stages

UNIT = "ms"


def read(record):
    if record.get("kind") != "train":
        return None
    return stages.device_ms(("sgns_scatter",), record.get("profiled_steps"))
