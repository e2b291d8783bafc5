"""Host milliseconds a query call spends decoding its block's hits into
(word, score) pairs: the program's ``decode_hits`` stage span, the exact
mean over every call of the run (``perfbench/stages.py``; the stage
table holds the whole process, which runs one cell)."""

from perfbench import stages

UNIT = "ms"


def read(record):
    if record.get("kind") != "query":
        return None
    return stages.host_mean_ms("decode_hits")
