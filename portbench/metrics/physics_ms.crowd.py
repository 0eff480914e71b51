"""physics_ms.crowd: host milliseconds per call inside the port's solver
step (span ``physics``); its one host read a step waits for the device work
queued before it."""

from portbench import trace


def read(run):
    return trace.per_call_ms(run, "physics")
