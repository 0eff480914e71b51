"""render_roofline.crowd: the render's least time (``roofline``: bytes from
the frame's inputs and output over the HBM rate) over the device time of
every operation launched inside the render span, in the profiled stretch,
in percent."""


def read(run):
    p = run.profile
    if p is None or not p["span_device_s"].get("render"):
        return None
    return p["render_least_s"] / p["span_device_s"]["render"] * 100.0
