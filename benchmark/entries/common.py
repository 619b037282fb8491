"""What the entries share: the port's configuration objects from a cell's
plain parameters, and dtypes by name."""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def as_config(cls, params: dict):
    """``cls(**params)`` with JSON lists as the tuples the port's frozen
    dataclasses hold."""
    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v
    names = set(cls.__dataclass_fields__)
    return cls(**{k: tup(v) for k, v in params.items() if k in names})


def n_stage(params: dict) -> int:
    return int(np.ceil(params["T_final"] / params["h"]))
