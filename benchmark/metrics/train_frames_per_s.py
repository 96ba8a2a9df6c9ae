"""train_frames_per_s: valid (unpadded) mel frames of every step in the
window, all ranks' together, over the window's wall time (whole epochs,
each ending on the loop's own sync)."""


def read(record):
    if record.get("driver") != "train" or "window_s" not in record:
        return None
    return record["frames"] / record["window_s"]
