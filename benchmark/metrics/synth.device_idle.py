"""synth.device_idle: share of the traced run of calls' wall time in which
no device operation ran."""


def read(record):
    trace = record.get("trace")
    if record.get("driver") != "synth" or not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
