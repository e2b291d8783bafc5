"""The profiled groups' share of their roofline: the least time of their
logical work (each distinct table row a group touches read and written
once plus the corpus ids it consumes, over 3.35 TB/s; or its model FLOPs
over 495 TFLOP/s, whichever is longer) over the device's busy time in
the sub-window that held them."""

UNIT = "%"


def read(record):
    tr = record.get("trace")
    if (record.get("kind") != "train" or not tr or not tr.get("busy_s")
            or not record.get("least_s")):
        return None
    return 100.0 * record["least_s"] / tr["busy_s"]
