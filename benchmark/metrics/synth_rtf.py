"""synth_rtf: the window's wall time over the audio seconds of every mel
returned in it (frames x hop / sample rate)."""


def read(record):
    if record.get("driver") != "synth" or "window_s" not in record:
        return None
    return record["window_s"] / record["audio_s"]
