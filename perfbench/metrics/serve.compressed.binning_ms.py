"""ms a served frame of the compressed model in binning: the stage mark "binning"."""


def read(r):
    return r.stage_ms("binning") if r.unit == "frame" else None
