"""synth.mfu: forward FLOPs of the encoder and the inverse decoder for the
traced calls' sentences at their own lengths, over the traced window's
wall time times the dense TF32 peak (495 TFLOP/s; serving is f32, its
products on the tensor cores in TF32 passes)."""


def read(record):
    trace = record.get("trace")
    if record.get("driver") != "synth" or not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * record["flops"] / (trace["window_s"] * record["peak_flops"])
