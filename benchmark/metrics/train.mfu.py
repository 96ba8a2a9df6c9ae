"""train.mfu: useful FLOPs of the traced steps (model_flops, each utterance
at its own lengths, all ranks) over the traced window's wall time times the
cards' dense peak (bf16 989 TFLOP/s a card under fp16_run)."""


def read(record):
    trace = record.get("trace")
    if record.get("driver") != "train" or not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * record["flops"] / (trace["window_s"] * record["peak_flops"] * record["world"])
