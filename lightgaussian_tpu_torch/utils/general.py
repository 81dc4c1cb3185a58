"""Run setup shared by the CLIs (port of `safe_state` of
`lightgaussian_tpu/utils/general.py`)."""
from __future__ import annotations

import random
import sys
from datetime import datetime

import numpy as np
import torch


def safe_state(quiet: bool = False) -> None:
    """Seed the host RNGs and torch's default generator with 0, and unless
    `quiet`, timestamp every stdout line (as the reference's `safe_state`
    does)."""
    random.seed(0)
    np.random.seed(0)
    torch.manual_seed(0)

    if not quiet and not getattr(sys.stdout, "_lg_wrapped", False):
        orig_write = sys.stdout.write

        def write(text):
            if text.endswith("\n") and text != "\n":
                ts = datetime.now().strftime("%d/%m %H:%M:%S")
                text = text.replace("\n", f" [{ts}]\n")
            return orig_write(text)

        sys.stdout.write = write
        sys.stdout._lg_wrapped = True
