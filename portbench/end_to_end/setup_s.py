"""`setup_s`: seconds from the process's start to the first timed step:
the scene from the seed, the pack and upload (or the streamed load), the
warm-up of every shape the cell's traffic uses."""


def read(w: dict):
    return w["setup_s"]
