"""ms a distillation step in binning: the stage mark "binning" of both its
renders, the teacher's and the student's."""


def read(r):
    return r.stage_ms("binning") if r.unit == "step" else None
