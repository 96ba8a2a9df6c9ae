"""train.device_ops_per_step: kernels, copies and sets in rank 0's trace of
one epoch, over its steps."""


def read(record):
    trace = record.get("trace")
    if record.get("driver") != "train" or not trace or not record.get("steps"):
        return None
    return trace["device_ops"] / record["steps"]
