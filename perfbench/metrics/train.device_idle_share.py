"""% of an unprofiled training step the device is idle: 1 - (busy time a step
in the profiled window: the union of kernel, memcpy and memset intervals) / (wall
time a step of the unprofiled window just before it)."""


def read(r):
    return r.idle_share("step")
