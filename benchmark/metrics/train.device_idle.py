"""train.device_idle: share of the traced epoch's wall time in which no
device operation ran (the union of device intervals; averaged over ranks)."""


def read(record):
    trace = record.get("trace")
    if record.get("driver") != "train" or not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
