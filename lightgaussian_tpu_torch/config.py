"""Configuration dataclasses: the reference's flag groups with the same names
and defaults (port of the model and pipeline groups of
`lightgaussian_tpu/config.py`; the optimisation group comes with the
training slice)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ModelParams:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"
    eval: bool = False


@dataclasses.dataclass
class PipelineParams:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
