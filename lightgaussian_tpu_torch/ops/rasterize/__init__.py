"""Rasterizer: preprocess, binning, the blend kernels, and the render API."""
from lightgaussian_tpu_torch.ops.rasterize.api import (  # noqa: F401
    RenderOutput,
    build_binning,
    count_render,
    default_max_instances,
    render,
)
