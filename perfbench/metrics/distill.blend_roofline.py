"""% of the blend kernels' device time in a distillation step that their least
time is: the exact blends (B1, the teacher's and the student's) and the
student's backward (B2), over every launch of the profiled steps, against the
least time of the pairs the frozen walk counts on those steps' own inputs
(perfbench/counting)."""


def read(r):
    return r.roofline("step", "blend_forward", "blend_backward")
