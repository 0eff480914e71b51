"""char_frames_per_s: characters x crowd steps completed in the window, over
the seconds from the first step's start to the end of the synchronise after
the last."""


def read(run):
    return run.calls * run.units_per_call / run.window_s if run.kind == "crowd" else None
