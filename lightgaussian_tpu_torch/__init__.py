"""lightgaussian_tpu_torch — the PyTorch/CUDA port of `lightgaussian_tpu`.

The package mirrors the JAX package module by module: the counterpart of
`lightgaussian_tpu/<path>.py` is `lightgaussian_tpu_torch/<path>.py`. Plain
tensor code is PyTorch; every Pallas TPU kernel on a ported path is a CUDA C++
kernel for Hopper (`csrc/`), built with `nvcc` at first use and bound with
`ctypes`. Each kernel keeps a plain PyTorch version beside it, which is what a
CPU tensor runs.

Entry points run on CUDA unless the caller asks for the CPU (`device="cpu"`,
`--device cpu`). Nothing here imports JAX or `lightgaussian_tpu`.
"""

__version__ = "0.1.0"
