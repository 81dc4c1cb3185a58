"""% of the H100's FP32 peak a training step uses: the least time of its
counted work (perfbench/counting) over the unprofiled wall time a step."""


def read(r):
    return r.mfu("step")
