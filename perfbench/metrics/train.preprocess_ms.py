"""ms a training step in the preprocess, forward and backward: the stage marks
"preprocess" (ended after the projection, SH colour and covariance) and
"preprocess backward" (the autograd backward after "B2 + reduce"). A step
that marks no "preprocess backward" (the distillation step) gives nothing."""


def read(r):
    if r.unit != "step" or r.stage_ms("preprocess backward") is None:
        return None
    return r.stage_ms("preprocess", "preprocess backward")
