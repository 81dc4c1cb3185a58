"""ms a distillation step in Adam: the stage mark "Adam". A program whose
distillation step marks no "Adam" gives nothing."""


def read(r):
    return r.stage_ms("Adam") if r.unit == "step" else None
