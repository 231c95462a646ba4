"""Carry a JAX parameter tree across to the torch engine.

``params_from_numpy`` takes the JAX package's parameter pytree after
``jax.tree.map(np.asarray, params)`` (nested dicts of numpy arrays), or
the tree of CPU tensors that ``models/weights.py::load_checkpoint`` reads
from a checkpoint directory, and returns the same dict structure of
torch tensors on ``device``, with the same leaf names, shapes and dtypes,
for each architecture the port runs
(Llama, OPT, Mixtral), or a tensor-parallel rank's slice of it (within
its pipeline stage's layers). Both
packages keep the ``[in, out]`` weight orientation, so no leaf is
transposed. ``draft_params_from_numpy``
does the same for a JAX ``DraftModel``'s tree, at the drafter's model
configuration. The parity tests use them to make both packages compute
with the same weights; this module imports nothing of JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from production_stack_tpu_torch.models.config import (
    ModelConfig,
    get_model_config,
)
from production_stack_tpu_torch.parallel.sharding import (
    check_pp,
    check_tp,
    shard_params,
)

ARCHS = ("llama", "opt", "mixtral")


def tensor_from_numpy(arr, device) -> torch.Tensor:
    """A numpy array (bfloat16 arrays included: numpy has no bf16 of its
    own, so they arrive as the ``ml_dtypes`` extension type) or a CPU
    tensor (the checkpoint loader's leaves) as a torch tensor of the same
    dtype on ``device``."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def params_from_numpy(tree: Dict, cfg: ModelConfig, device, rank: int = 0,
                      tp: int = 1, stage: int = 0, pp: int = 1) -> Dict:
    """The JAX parameter tree (as numpy) as the torch parameter dict; with
    ``tp > 1``, rank ``rank``'s slice of it (``parallel/sharding.py``),
    and with ``pp > 1`` only the layers of stage ``stage``, only that
    slice copied to ``device``."""
    if cfg.arch not in ARCHS:
        raise ValueError(f"Unknown arch {cfg.arch!r}")
    check_tp(cfg, tp)
    check_pp(cfg, pp)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        t = tensor_from_numpy(node, device)
        # A slice must not keep (or write through to) the whole leaf.
        sliced = tp > 1 or pp > 1
        return t.clone() if sliced and t.device.type == "cpu" else t

    return convert(shard_params(tree, cfg, rank, tp, stage=stage, pp=pp))


def draft_params_from_numpy(tree: Dict, engine_config, device) -> Dict:
    """A JAX ``DraftModel``'s parameter tree (as numpy) as the port
    drafter's dict: the model ``engine_config.speculative_draft_model``
    at the engine's dtype, which has no LoRA slots."""
    cfg = get_model_config(engine_config.speculative_draft_model)
    if engine_config.dtype:
        cfg = cfg.replace(dtype=engine_config.dtype)
    if "lora" in tree:
        raise ValueError("a draft model carries no LoRA slots")
    return params_from_numpy(tree, cfg, device)
