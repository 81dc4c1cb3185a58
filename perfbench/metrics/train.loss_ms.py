"""ms a training step in the loss: the stage marks "loss forward" (L1 and the
SSIM moments, B3) and "loss backward" (their gradient, B4). A step that marks
no "loss forward" gives nothing."""


def read(r):
    if r.unit != "step" or r.stage_ms("loss forward") is None:
        return None
    return r.stage_ms("loss forward", "loss backward")
