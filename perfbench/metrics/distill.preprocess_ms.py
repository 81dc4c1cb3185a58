"""ms a distillation step in the preprocess, forward and backward: the stage
marks "preprocess" of both renders (the teacher's and the student's) and
"preprocess backward" (the student's autograd backward after "B2 + reduce").
A program whose distillation step marks no "preprocess backward" gives
nothing."""


def read(r):
    if r.unit != "step" or r.stage_ms("preprocess backward") is None:
        return None
    return r.stage_ms("preprocess", "preprocess backward")
