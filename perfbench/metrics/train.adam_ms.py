"""ms a training step in Adam: the stage mark "Adam"."""


def read(r):
    return r.stage_ms("Adam") if r.unit == "step" else None
