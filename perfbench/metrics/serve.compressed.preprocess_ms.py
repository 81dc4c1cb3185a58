"""ms a served frame of the compressed model in the preprocess: the stage mark "preprocess"."""


def read(r):
    return r.stage_ms("preprocess") if r.unit == "frame" else None
