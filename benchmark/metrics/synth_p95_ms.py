"""synth_p95_ms: the 95th percentile of every call's latency in the window
(host clock from the call until synth returns host arrays)."""

import numpy as np


def read(record):
    if record.get("driver") != "synth" or "window_s" not in record:
        return None
    return float(np.percentile(np.asarray(record["latencies_ms"]), 95))
