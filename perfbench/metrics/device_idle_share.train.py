"""Share of the timed window of a training run in which no operation ran
on the device: 1 - (the device's busy seconds a step in the device-only
profile, times the window's steps) / the window's seconds. The busy time
a step comes from the profiled sub-window (``perfbench/trace.py``), whose
own length the profiler stretches; the window's steps and seconds are
the untraced window's."""

UNIT = "%"


def read(record):
    tr = record.get("trace")
    if (record.get("kind") != "train" or not tr or not tr.get("busy_s")
            or not record.get("profiled_steps")):
        return None
    busy = tr["busy_s"] / record["profiled_steps"] * record["steps"]
    return 100.0 * (1.0 - busy / record["window_s"])
