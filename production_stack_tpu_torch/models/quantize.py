"""Weight-only int8 quantization (per-output-channel, symmetric).

The port's own copy of ``production_stack_tpu/models/quantize.py``: each
weight is stored as ``int8`` plus a ``float32`` scale per output channel
(``scale = max(amax, 1e-8) / 127``, codes rounded half to even and
clipped to [-127, 127]), and the model multiplies by the scale after the
product (``models/llama.py::_proj``). Layer weights are quantized; the
embedding table and ``lm_head`` only with ``quantize_embeddings``.

Two entry points with the JAX package's semantics:

- :func:`quantize_loaded`: for host-loaded checkpoints, a copy of the JAX
  function; numpy leaves go through numpy, CPU tensor leaves (the
  port's checkpoint loader, ``models/weights.py``) through
  :func:`quantize_tensor`, which gives the same codes and scales;
- :func:`quantize_tensor`: torch, the twin of the JAX ``quantize_tree``
  leaf rule, used by ``models/llama.py::init_params`` to quantize each
  leaf as it is drawn, so a random-init 8B model never exists whole in
  bf16 on the card.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# Weight leaves quantized for the llama family; everything else (norms,
# LoRA slots) stays in the working dtype.
LLAMA_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# Symmetric int8 range. 127 (not 128) keeps the scale exact for the max.
_QMAX = 127.0


def _quantize_np(w: np.ndarray, reduce_axis: int):
    w32 = np.asarray(w, np.float32)
    amax = np.max(np.abs(w32), axis=reduce_axis, keepdims=True)
    scale = np.maximum(amax, 1e-8) / _QMAX
    q = np.clip(np.round(w32 / scale), -_QMAX, _QMAX).astype(np.int8)
    return q, scale.astype(np.float32)


def _quantize_leaf(w, reduce_axis: int):
    if isinstance(w, torch.Tensor):
        return quantize_tensor(w, reduce_axis)
    return _quantize_np(w, reduce_axis)


def quantize_loaded(loaded: Dict, arch: str, *,
                    quantize_embeddings: bool = False) -> Dict:
    """Int8-quantize a host-loaded parameter tree (numpy arrays or CPU
    tensors). Only quantizes the leaves the tree actually carries."""
    if arch != "llama":
        raise ValueError(
            f"int8 quantization is supported for the llama family "
            f"(got arch {arch!r})")
    out = dict(loaded)
    if "layers" in loaded:
        layers = dict(loaded["layers"])
        for name in LLAMA_LAYER_KEYS:
            if name in layers:
                q, s = _quantize_leaf(layers[name], -2)
                layers[name] = q
                layers[name + "_scale"] = s
        out["layers"] = layers
    if quantize_embeddings:
        if "embed" in loaded:
            q, s = _quantize_leaf(loaded["embed"], -1)
            out["embed"] = q
            out["embed_scale"] = s
        if "lm_head" in loaded:
            q, s = _quantize_leaf(loaded["lm_head"], -2)
            out["lm_head"] = q
            out["lm_head_scale"] = s
    return out


def _quantize(w: torch.Tensor, dim: int):
    w32 = w.float()
    amax = w32.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp_min(1e-8) / _QMAX
    q = torch.clamp(torch.round(w32 / scale), -_QMAX, _QMAX)
    return q.to(torch.int8), scale


def quantize_tensor(w: torch.Tensor, reduce_axis: int):
    """``(int8 codes, float32 scales)`` of one weight leaf, the scale
    reduced over ``reduce_axis`` (kept as a size-1 dim): -2 for ``[in,
    out]`` weights and layer stacks ``[L, in, out]``, -1 for the
    ``[V, Hd]`` embedding. A layer stack is quantized one layer at a time,
    so the float32 temporaries stay one layer's size."""
    if w.dim() == 3 and reduce_axis < 0:
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        shape = list(w.shape)
        shape[reduce_axis] = 1
        s = torch.empty(shape, dtype=torch.float32, device=w.device)
        for layer in range(w.shape[0]):
            q[layer], s[layer] = _quantize(w[layer], reduce_axis)
        return q, s
    return _quantize(w, reduce_axis)
