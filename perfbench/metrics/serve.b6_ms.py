"""ms a served frame in the render-only blend (B6): the stage mark "B6"."""


def read(r):
    return r.stage_ms("B6") if r.unit == "frame" else None
