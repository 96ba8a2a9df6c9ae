"""train_peak_gib: torch.cuda.max_memory_allocated over the window, reset
after warm-up; the largest over ranks, in GiB."""


def read(record):
    if record.get("driver") != "train" or "window_s" not in record:
        return None
    return record["peak_bytes"] / 2 ** 30
