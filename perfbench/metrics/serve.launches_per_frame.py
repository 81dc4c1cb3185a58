"""Kernel launches a served frame: kernel events of the profiled window over
its frames."""


def read(r):
    return r.launches("frame")
