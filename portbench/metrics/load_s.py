"""load_s: host seconds of the load (the model's parse and build and the
clip's, through the port's public loaders)."""


def read(run):
    return run.load_s
