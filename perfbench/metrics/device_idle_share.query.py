"""Share of the timed window of a query run in which no operation ran on
the device: 1 - (the device's busy seconds a call in the device-only
profile, times the window's calls) / the window's seconds, as the
training metric reads it."""

UNIT = "%"


def read(record):
    tr = record.get("trace")
    if (record.get("kind") != "query" or not tr or not tr.get("busy_s")
            or not record.get("profiled_calls")):
        return None
    busy = tr["busy_s"] / record["profiled_calls"] * record["calls"]
    return 100.0 * (1.0 - busy / record["window_s"])
