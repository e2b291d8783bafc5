"""Device milliseconds a query call spends selecting its neighbours (the
mask terms, the multiply-add on the transposed scores and ``topk``): the
program's ``topk_select`` stage span, mean over the calls of the
device-only profile (``perfbench/stages.py``; the stage table holds the
whole process, which runs one cell)."""

from perfbench import stages

UNIT = "ms"


def read(record):
    if record.get("kind") != "query":
        return None
    return stages.device_ms(("topk_select",), record.get("profiled_calls"))
