"""The weights of a run, drawn from the seed on the card.

The layout is frozen here: the leaf names, ``[in, out]`` orientation
and layer-stacked leaves that the port's ``init_params`` of
``models/llama.py`` and ``models/mixtral.py`` produce, with normal
weights scaled by ``1 / sqrt(fan_in)`` (0.02 for the embedding) and unit
norms. Each (leaf, layer) is drawn by a generator of its own, seeded
from the run's seed and the leaf's name, in the served dtype, so the
plain reference can draw any one layer again without the program's
tensors and get the same values.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch

from portbench.spec import Shape


def layer_leaves(s: Shape) -> List[Tuple[str, tuple, float]]:
    """(name, shape of one layer's slice, std) of each drawn layer leaf,
    in drawing order."""
    H, KVH, D, Hd, I = s.heads, s.kv_heads, s.head_dim, s.hidden, \
        s.intermediate
    attn = [("wq", (Hd, H * D), Hd ** -0.5),
            ("wk", (Hd, KVH * D), Hd ** -0.5),
            ("wv", (Hd, KVH * D), Hd ** -0.5),
            ("wo", (H * D, Hd), (H * D) ** -0.5)]
    if s.experts:
        E = s.experts
        return attn + [("router", (Hd, E), Hd ** -0.5),
                       ("w_gate", (E, Hd, I), Hd ** -0.5),
                       ("w_up", (E, Hd, I), Hd ** -0.5),
                       ("w_down", (E, I, Hd), I ** -0.5)]
    return attn + [("w_gate", (Hd, I), Hd ** -0.5),
                   ("w_up", (Hd, I), Hd ** -0.5),
                   ("w_down", (I, Hd), I ** -0.5)]


def whole_leaves(s: Shape) -> List[Tuple[str, tuple, float]]:
    return [("embed", (s.vocab, s.hidden), 0.02),
            ("lm_head", (s.hidden, s.vocab), s.hidden ** -0.5)]


def leaf_seed(seed: int, name: str, layer: int = -1) -> int:
    h = hashlib.blake2b(f"{seed}/{name}/{layer}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def fill(out: torch.Tensor, seed: int, name: str, layer: int,
         std: float) -> torch.Tensor:
    """Draw one (leaf, layer) into ``out`` (contiguous, on its device)."""
    g = torch.Generator(device=out.device)
    g.manual_seed(leaf_seed(seed, name, layer))
    return out.normal_(generator=g).mul_(std)


def draw_layer(s: Shape, seed: int, name: str, layer: int, dtype,
               device) -> torch.Tensor:
    """One layer's slice of leaf ``name``, drawn alone."""
    shape, std = {n: (sh, sd) for n, sh, sd in layer_leaves(s)}[name]
    return fill(torch.empty(shape, dtype=dtype, device=device), seed, name,
                layer, std)


def draw_whole(s: Shape, seed: int, name: str, dtype,
               device) -> torch.Tensor:
    shape, std = {n: (sh, sd) for n, sh, sd in whole_leaves(s)}[name]
    return fill(torch.empty(shape, dtype=dtype, device=device), seed, name,
                -1, std)


def draw_params(s: Shape, seed: int, dtype, device) -> Dict:
    """The whole parameter dict in the port's layout."""
    L = s.layers
    with torch.no_grad():
        layers = {"attn_norm": torch.ones((L, s.hidden), dtype=dtype,
                                          device=device),
                  "mlp_norm": torch.ones((L, s.hidden), dtype=dtype,
                                         device=device)}
        for name, shape, std in layer_leaves(s):
            t = torch.empty((L,) + shape, dtype=dtype, device=device)
            for layer in range(L):
                fill(t[layer], seed, name, layer, std)
            layers[name] = t
        params = {"layers": layers,
                  "final_norm": torch.ones((s.hidden,), dtype=dtype,
                                           device=device)}
        for name, _, _ in whole_leaves(s):
            params[name] = draw_whole(s, seed, name, dtype, device)
    return params
