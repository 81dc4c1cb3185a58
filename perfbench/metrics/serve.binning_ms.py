"""ms a served frame in binning: the stage mark "binning"."""


def read(r):
    return r.stage_ms("binning") if r.unit == "frame" else None
