"""frame_p90_ms: the 90th percentile of every frame's latency in the window,
on the host clock around each ``Engine.render`` call, readback included."""

import numpy as np


def read(run):
    if run.kind != "viewer" or not run.calls:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 90)) * 1e3
