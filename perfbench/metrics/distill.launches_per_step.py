"""Kernel launches a distillation step: kernel events of the profiled window over
its steps (autograd, eager and hand-written launches alike)."""


def read(r):
    return r.launches("step")
