"""train.busy_peak_share: the same FLOPs over the device's busy time (the
union of its operations, averaged over ranks) times the cards' peak: the
kernels' joint share of the roof while the card works."""


def read(record):
    trace = record.get("trace")
    if record.get("driver") != "train" or not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * record["flops"] / (trace["busy_s"] * record["peak_flops"] * record["world"])
