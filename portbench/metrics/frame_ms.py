"""frame_ms: the window's milliseconds over the frames completed in it."""


def read(run):
    return run.window_s / run.calls * 1e3 if run.kind == "viewer" and run.calls else None
