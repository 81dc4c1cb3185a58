"""ms a distillation step in the loss: the stage marks "loss forward" (L1 and
the five-moment SSIM against the teacher's image, B7) and "loss backward"
(their gradient, B4 over 15 planes). A program whose distillation step marks
no "loss forward" gives nothing."""


def read(r):
    if r.unit != "step" or r.stage_ms("loss forward") is None:
        return None
    return r.stage_ms("loss forward", "loss backward")
