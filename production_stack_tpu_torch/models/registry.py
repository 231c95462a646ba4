"""Model registry: arch name -> (init_params, apply)."""

from __future__ import annotations

from typing import Callable, Tuple

from production_stack_tpu_torch.models.config import ModelConfig


def build_model(cfg: ModelConfig) -> Tuple[Callable, Callable]:
    """Return (init_params, apply) for ``cfg.arch``."""
    if cfg.arch == "llama":
        from production_stack_tpu_torch.models import llama as mod
    elif cfg.arch == "opt":
        from production_stack_tpu_torch.models import opt as mod
    elif cfg.arch == "mixtral":
        from production_stack_tpu_torch.models import mixtral as mod
    else:
        raise ValueError(f"Unknown arch {cfg.arch!r}")
    return mod.init_params, mod.apply
