"""% of the H100's FP32 peak a served frame uses: the least time of its
counted work over the unprofiled wall time a frame."""


def read(r):
    return r.mfu("frame")
