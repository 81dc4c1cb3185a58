"""ms a training step in binning: the stage mark "binning"."""


def read(r):
    return r.stage_ms("binning") if r.unit == "step" else None
