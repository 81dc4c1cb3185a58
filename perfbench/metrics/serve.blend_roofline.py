"""% of the render-only blend's (B6) device time in the profiled frames that its
least time is, from the pairs the frozen walk counts on those frames' inputs."""


def read(r):
    return r.roofline("frame", "blend_forward_fast")
