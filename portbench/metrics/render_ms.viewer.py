"""render_ms.viewer: host milliseconds per call inside the port's render
entry (span ``render``: triangle setup, pair tables, kernel launches, bloom)."""

from portbench import trace


def read(run):
    return trace.per_call_ms(run, "render")
