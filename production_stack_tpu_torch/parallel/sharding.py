"""Sharding rules: which slice of every parameter a tensor-parallel rank
holds.

The port's own copy of the rules in ``production_stack_tpu/parallel/
sharding.py`` (Megatron-style tensor parallelism), written for ranks that
each hold a slice and run hand-placed collectives instead of GSPMD:

- attention q/k/v projections: column-parallel on the head axis; ``wo``:
  row-parallel (one all-reduce after it);
- MLP gate/up: column-parallel on the intermediate axis; down:
  row-parallel (one all-reduce after it);
- Mixtral experts: split over the ranks on the expert axis; the router is
  replicated;
- ``lm_head``: vocab-sharded (the logits' shards are gathered on every
  rank); the input embedding, norms and the row-parallel biases (OPT's
  ``wo_b``, ``fc2_b``) are replicated;
- LoRA: the B matrices split on their output like their base
  projection, the A matrices and the scaling are replicated;
- an int8 ``<name>_scale`` follows its base leaf; where that axis
  collapsed to 1 (the row-parallel scales, reduced over the split input
  axis) the scale is the whole leaf's, replicated.

KV heads split where ``num_kv_heads % tp == 0``. Where ``tp >
num_kv_heads`` (and ``tp % num_kv_heads == 0``), each rank holds the one
KV head its q heads read, ``tp / num_kv_heads`` copies of each: what the
JAX engine's ``kv_pages_sharding`` leaves replicated.

Where GSPMD would fall back to a replicated leaf (``_divisible``), a rank
here cannot: its collectives assume every layer is split the same way.
:func:`check_tp` therefore raises ``ValueError`` at construction, naming
the dimension that does not divide.

Axes are counted from the end, so one rule serves a stacked ``[L, ...]``
leaf and one layer's view of it.
"""

from __future__ import annotations

from typing import Dict, Tuple

KV = "kv"  # the rule of a leaf split on KV heads (last axis)

# Leaf key -> the axis it splits on (negative), KV for KV-head columns, or
# None for replicated leaves.
_LLAMA_SPLITS = {
    ("embed",): None,
    ("final_norm",): None,
    ("lm_head",): -1,
    ("layers", "attn_norm"): None,
    ("layers", "mlp_norm"): None,
    ("layers", "wq"): -1,
    ("layers", "wk"): KV,
    ("layers", "wv"): KV,
    ("layers", "wo"): -2,
    ("layers", "w_gate"): -1,
    ("layers", "w_up"): -1,
    ("layers", "w_down"): -2,
    ("lora", "wq_a"): None,
    ("lora", "wq_b"): -1,
    ("lora", "wv_a"): None,
    ("lora", "wv_b"): KV,
    ("lora", "scaling"): None,
}

_OPT_SPLITS = {
    ("embed",): None,
    ("pos_embed",): None,
    ("final_ln_w",): None,
    ("final_ln_b",): None,
    ("layers", "ln1_w"): None,
    ("layers", "ln1_b"): None,
    ("layers", "ln2_w"): None,
    ("layers", "ln2_b"): None,
    ("layers", "wq"): -1,
    ("layers", "wq_b"): -1,
    ("layers", "wk"): KV,
    ("layers", "wk_b"): KV,
    ("layers", "wv"): KV,
    ("layers", "wv_b"): KV,
    ("layers", "wo"): -2,
    ("layers", "wo_b"): None,
    ("layers", "fc1"): -1,
    ("layers", "fc1_b"): -1,
    ("layers", "fc2"): -2,
    ("layers", "fc2_b"): None,
}

_MIXTRAL_SPLITS = {
    ("embed",): None,
    ("final_norm",): None,
    ("lm_head",): -1,
    ("layers", "attn_norm"): None,
    ("layers", "mlp_norm"): None,
    ("layers", "wq"): -1,
    ("layers", "wk"): KV,
    ("layers", "wv"): KV,
    ("layers", "wo"): -2,
    ("layers", "router"): None,
    # Experts [.., E, in, out]: expert parallelism on the tp ranks.
    ("layers", "w_gate"): -3,
    ("layers", "w_up"): -3,
    ("layers", "w_down"): -3,
}

_SPLITS = {"llama": _LLAMA_SPLITS, "opt": _OPT_SPLITS,
           "mixtral": _MIXTRAL_SPLITS}

# Row-parallel leaves: their products are partial sums over the split
# input axis (one all-reduce after each).
ROW_PARALLEL = ("wo", "w_down", "fc2")


def check_tp(cfg, tp: int) -> None:
    """Raise ValueError, naming the dimension, unless every layer of
    ``cfg`` splits evenly over ``tp`` ranks."""
    if tp < 1:
        raise ValueError(f"tensor_parallel_size must be >= 1, got {tp}")
    if tp == 1:
        return
    dims = [("num_heads", cfg.num_heads)]
    if cfg.arch == "mixtral":
        dims.append(("num_experts", cfg.num_experts))
    else:
        dims.append(("intermediate_size", cfg.intermediate_size))
    if cfg.arch != "opt" and not cfg.tie_word_embeddings:
        dims.append(("vocab_size", cfg.vocab_size))
    for name, size in dims:
        if size % tp:
            raise ValueError(
                f"{name} {size} is not divisible by tensor_parallel_size "
                f"{tp}")
    kvh = cfg.num_kv_heads
    if kvh % tp and tp % kvh:
        raise ValueError(
            f"num_kv_heads {kvh} and tensor_parallel_size {tp}: neither "
            f"divides the other")


def kv_heads_local(cfg, tp: int) -> int:
    """KV heads a rank's pool holds: ``num_kv_heads / tp``, or the one
    head its q heads read when ``tp > num_kv_heads``."""
    return max(cfg.num_kv_heads // tp, 1)


def kv_head_start(cfg, rank: int, tp: int) -> int:
    """The first (global) KV head of rank ``rank``."""
    kvh = cfg.num_kv_heads
    if kvh % tp == 0:
        return rank * (kvh // tp)
    return rank // (tp // kvh)


def split_rule(arch: str, key: Tuple[str, ...]):
    """The rule of a leaf key: the axis it splits on, ``KV``, or None
    (replicated). A ``<name>_scale`` takes its base leaf's rule."""
    if key[-1].endswith("_scale"):
        key = key[:-1] + (key[-1][: -len("_scale")],)
    splits = _SPLITS[arch]
    if key not in splits:
        raise KeyError(f"no sharding rule for {arch} leaf {'.'.join(key)}")
    return splits[key]


def slice_leaf(key: Tuple[str, ...], leaf, cfg, rank: int, tp: int):
    """Rank ``rank``'s slice of a whole leaf (a numpy array or a tensor;
    a view, which the caller copies). ``key`` is the leaf's path in the
    parameter tree, e.g. ``("layers", "wq")``."""
    if tp == 1:
        return leaf
    rule = split_rule(cfg.arch, key)
    if rule is None:
        return leaf
    if rule == KV:
        axis = -1
        width = leaf.shape[-1]
        if width == 1:
            return leaf  # a scale reduced over this axis
        per_head = width // cfg.num_kv_heads
        start = kv_head_start(cfg, rank, tp) * per_head
        n = kv_heads_local(cfg, tp) * per_head
    else:
        axis = rule
        width = leaf.shape[axis]
        if width == 1:
            return leaf  # a row-parallel scale: the whole leaf's
        if width % tp:
            raise ValueError(
                f"leaf {'.'.join(key)} axis {axis} of size {width} does not "
                f"split over {tp} ranks")
        n = width // tp
        start = rank * n
    index = [slice(None)] * len(leaf.shape)
    index[axis] = slice(start, start + n)
    return leaf[tuple(index)]


def shard_params(tree: Dict, cfg, rank: int, tp: int,
                 prefix: Tuple[str, ...] = ()) -> Dict:
    """The tree of rank ``rank``'s slices (views) of a whole parameter
    tree: the JAX engine's tree as numpy, a checkpoint's CPU tensors or
    a parameter dict."""
    out = {}
    for name, node in tree.items():
        key = prefix + (name,)
        if isinstance(node, dict):
            out[name] = shard_params(node, cfg, rank, tp, key)
        else:
            out[name] = slice_leaf(key, node, cfg, rank, tp)
    return out


def is_row_parallel(key: Tuple[str, ...]) -> bool:
    """Whether a leaf (or its scale) is a row-parallel weight."""
    name = key[-1]
    if name.endswith("_scale"):
        name = name[: -len("_scale")]
    return key[0] == "layers" and name in ROW_PARALLEL


def local_shape(key: Tuple[str, ...], shape, cfg, rank: int,
                tp: int) -> tuple:
    """The shape of rank ``rank``'s slice of a leaf of ``shape``."""
    import torch

    meta = torch.empty(tuple(shape), device="meta")
    return tuple(slice_leaf(key, meta, cfg, rank, tp).shape)
