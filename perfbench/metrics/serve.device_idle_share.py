"""% of an unprofiled served frame the device is idle: 1 - (busy time a frame
in the profiled window) / (wall time a frame of the unprofiled window before it)."""


def read(r):
    return r.idle_share("frame")
