"""PyTorch model definitions (Llama, OPT, Mixtral) over parameter dicts."""

from production_stack_tpu_torch.models.config import ModelConfig, get_model_config
from production_stack_tpu_torch.models.registry import build_model

__all__ = ["ModelConfig", "get_model_config", "build_model"]
