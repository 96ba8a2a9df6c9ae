"""synth.device_ops_per_call: kernels, copies and sets in the traced run of
calls, over its calls."""


def read(record):
    trace = record.get("trace")
    if record.get("driver") != "synth" or not trace or not record.get("calls"):
        return None
    return trace["device_ops"] / record["calls"]
