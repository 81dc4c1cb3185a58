"""Configuration dataclasses: the reference's flag groups with the same names
and defaults (port of `lightgaussian_tpu/config.py`), kept in the model
directory as JSON."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional


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


@dataclasses.dataclass
class OptimizationParams:
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002


@dataclasses.dataclass
class TrainConfig:
    """What the training CLIs share beyond the three groups."""

    model: ModelParams = dataclasses.field(default_factory=ModelParams)
    pipeline: PipelineParams = dataclasses.field(default_factory=PipelineParams)
    opt: OptimizationParams = dataclasses.field(default_factory=OptimizationParams)
    test_iterations: List[int] = dataclasses.field(default_factory=lambda: [7_000, 30_000])
    save_iterations: List[int] = dataclasses.field(default_factory=lambda: [7_000, 30_000])
    checkpoint_iterations: List[int] = dataclasses.field(default_factory=list)
    start_checkpoint: Optional[str] = None
    # the in-training GSS prune schedule
    prune_iterations: List[int] = dataclasses.field(default_factory=lambda: [16_000, 24_000])
    prune_percent: float = 0.5
    prune_decay: float = 0.6
    v_pow: float = 0.1
    seed: int = 0


_GROUPS = {"ModelParams": ModelParams, "PipelineParams": PipelineParams, "OptimizationParams": OptimizationParams}


def save_config(cfg, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(dataclasses.asdict(cfg), indent=2))


def load_config(cls, path: str | Path):
    """A `cls` from the JSON `save_config` wrote; unknown keys are ignored."""
    raw = json.loads(Path(path).read_text())

    def build(c, d):
        fields = {f.name: f for f in dataclasses.fields(c)}
        kwargs = {}
        for k, v in d.items():
            if k not in fields:
                continue
            ft = fields[k].type
            kwargs[k] = build(_GROUPS[ft], v) if isinstance(v, dict) and ft in _GROUPS else v
        return c(**kwargs)

    return build(cls, raw)
