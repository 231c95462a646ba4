"""Checkpoint loading: HuggingFace safetensors or torch weights -> the
port's parameter trees.

The port of ``production_stack_tpu/models/weights.py`` (the JAX loader),
for the Llama family, OPT and Mixtral. :func:`load_checkpoint` returns
the nested tree the JAX loader returns, with the same leaf names and
layouts: layer leaves stacked on a leading axis, projections transposed
from HF's ``[out, in]`` to the models' ``x @ W`` ``[in, out]``, every leaf
cast to the model dtype. Its leaves are CPU tensors; the engine carries
the tree onto the device with ``models/convert.py::params_from_numpy``.
A checkpoint that lacks a tensor the architecture needs raises, naming
the tensors, rather than serving anything else.

Safetensors files are read with the standard library and
``torch.frombuffer`` (:func:`read_safetensors`): an 8-byte little-endian
header length, a JSON header of ``{name: {dtype, shape, data_offsets}}``,
then the raw little-endian bytes, memory-mapped and copied once into the
stacked leaves. :func:`save_safetensors` writes the same format, and
:func:`save_checkpoint` a whole directory (``config.json`` and the
tensors under their HF names, :func:`hf_tensors`). ``pytorch_model*.bin``
shards are read with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.parallel.sharding import slice_leaf
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

# Safetensors dtype tags and their torch dtypes.
SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I8": torch.int8, "U8": torch.uint8,
    "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "BOOL": torch.bool,
}
_TAGS = {dtype: tag for tag, dtype in SAFETENSORS_DTYPES.items()}


def read_safetensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield ``(name, tensor)`` of one safetensors file, in file order.
    The tensors are views of a private (copy-on-write) memory map of the
    file; a header that does not match the file's size raises."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n).decode("utf-8"))
        size = os.fstat(f.fileno()).st_size
        mm = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
              if size > 8 + n else None)
    base = 8 + n
    entries = sorted(((name, info) for name, info in header.items()
                      if name != "__metadata__"),
                     key=lambda e: e[1]["data_offsets"][0])
    for name, info in entries:
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported "
                             f"dtype {info['dtype']!r}")
        shape = [int(d) for d in info["shape"]]
        start, end = (int(o) for o in info["data_offsets"])
        numel = 1
        for d in shape:
            numel *= d
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != numel * itemsize or base + end > size:
            raise ValueError(f"{path}: tensor {name!r} spans bytes "
                             f"[{start}, {end}), not {numel} x {itemsize}")
        if numel == 0:
            yield name, torch.empty(shape, dtype=dtype)
            continue
        yield name, torch.frombuffer(mm, dtype=dtype, count=numel,
                                     offset=base + start).view(shape)


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str,
                     metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (any device; written in insertion order) as one
    safetensors file; returns the bytes written."""
    header: Dict[str, dict] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)  # data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            if t.numel():
                host = t.detach().cpu().contiguous().reshape(-1)
                f.write(memoryview(host.view(torch.uint8).numpy()))
    return 8 + len(blob) + offset


def _iter_checkpoint_tensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield ``(name, tensor)`` from all safetensors or torch shards."""
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        for f in st_files:
            yield from read_safetensors(f)
        return
    bin_files = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if not bin_files:
        raise FileNotFoundError(
            f"no *.safetensors or pytorch_model*.bin under {path}")
    for f in bin_files:
        state = torch.load(f, map_location="cpu", weights_only=True)
        yield from state.items()


def _owned(t: torch.Tensor, dtype) -> torch.Tensor:
    """A contiguous copy of ``t`` in ``dtype``, owning its memory (never a
    view of a file's map)."""
    out = torch.empty(t.shape, dtype=dtype)
    out.copy_(t)
    return out


def _stacked(views: List, dtype, cut, key) -> torch.Tensor:
    """The per-layer leaves (or per-layer lists of per-expert leaves)
    stacked on new leading axes, cast in the one copy; ``cut(key, x)``
    gives the part of a layer's leaf (or list of experts) to keep, and
    ``cut.layers`` (when set) the layers to keep."""
    layers = getattr(cut, "layers", None)
    if layers is not None:
        views = views[layers.start:layers.stop]
    views = [cut(key, v) for v in views]
    nested = isinstance(views[0], list)
    inner = views[0][0] if nested else views[0]
    shape = ((len(views),) + ((len(views[0]),) if nested else ())
             + tuple(inner.shape))
    out = torch.empty(shape, dtype=dtype)
    for i, v in enumerate(views):
        if nested:
            for e, x in enumerate(v):
                out[i, e].copy_(x)
        else:
            out[i].copy_(v)
    return out


def _check_missing(path: str, missing: List[str], unmapped: List[str]):
    if missing:
        raise ValueError(
            f"checkpoint at {path} is missing tensors: {missing[:8]}"
            + (f" (+{len(missing) - 8} more)" if len(missing) > 8 else ""))
    if unmapped:
        logger.warning("checkpoint: %d unmapped tensors (e.g. %s)",
                       len(unmapped), unmapped[:3])


def _missing_layers(per_layer: Dict[str, List]) -> List[str]:
    return [f"layers.{k}[{i}]" for k, v in per_layer.items()
            for i, leaf in enumerate(v) if leaf is None]


# --------------------------------------------------------------------- #
# Llama family (llama / mistral)
# --------------------------------------------------------------------- #

_LLAMA_LAYER_MAP = {
    "input_layernorm.weight": ("attn_norm", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
}


def _load_llama(cfg: ModelConfig, path: str, cut) -> Dict:
    L, dtype = cfg.num_layers, cfg.torch_dtype
    per_layer: Dict[str, List] = {
        key: [None] * L for key, _ in _LLAMA_LAYER_MAP.values()}
    top: Dict[str, torch.Tensor] = {}
    unmapped: List[str] = []
    for name, t in _iter_checkpoint_tensors(path):
        if name == "model.embed_tokens.weight":
            top["embed"] = _owned(t, dtype)
        elif name == "model.norm.weight":
            top["final_norm"] = _owned(t, dtype)
        elif name == "lm_head.weight":
            top["lm_head"] = _owned(cut(("lm_head",), t.T), dtype)
        elif name.startswith("model.layers."):
            idx, leaf = name[len("model.layers."):].split(".", 1)
            entry = _LLAMA_LAYER_MAP.get(leaf)
            if entry is None or int(idx) >= L:
                unmapped.append(name)
                continue
            key, transpose = entry
            per_layer[key][int(idx)] = t.T if transpose else t
        elif name.endswith("rotary_emb.inv_freq"):
            continue  # computed, not a parameter
        else:
            unmapped.append(name)
    missing = _missing_layers(per_layer) + [
        k for k in ("embed", "final_norm") if k not in top]
    _check_missing(path, missing, unmapped)
    params: Dict = {
        "embed": top["embed"],
        "final_norm": top["final_norm"],
        "layers": {k: _stacked(v, dtype, cut, ("layers", k))
                   for k, v in per_layer.items()},
    }
    if not cfg.tie_word_embeddings and "lm_head" in top:
        params["lm_head"] = top["lm_head"]  # else the model uses embed.T
    return params


# --------------------------------------------------------------------- #
# OPT
# --------------------------------------------------------------------- #

_OPT_LAYER_MAP = {
    "self_attn_layer_norm.weight": ("ln1_w", False),
    "self_attn_layer_norm.bias": ("ln1_b", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.q_proj.bias": ("wq_b", False),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.k_proj.bias": ("wk_b", False),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.v_proj.bias": ("wv_b", False),
    "self_attn.out_proj.weight": ("wo", True),
    "self_attn.out_proj.bias": ("wo_b", False),
    "final_layer_norm.weight": ("ln2_w", False),
    "final_layer_norm.bias": ("ln2_b", False),
    "fc1.weight": ("fc1", True),
    "fc1.bias": ("fc1_b", False),
    "fc2.weight": ("fc2", True),
    "fc2.bias": ("fc2_b", False),
}
_OPT_TOP = {"embed_tokens.weight": "embed",
            "embed_positions.weight": "pos_embed",
            "final_layer_norm.weight": "final_ln_w",
            "final_layer_norm.bias": "final_ln_b"}


def _load_opt(cfg: ModelConfig, path: str, cut) -> Dict:
    L, dtype = cfg.num_layers, cfg.torch_dtype
    per_layer: Dict[str, List] = {
        key: [None] * L for key, _ in _OPT_LAYER_MAP.values()}
    top: Dict[str, torch.Tensor] = {}
    unmapped: List[str] = []
    prefix = "model.decoder."
    for name, t in _iter_checkpoint_tensors(path):
        short = name[len(prefix):] if name.startswith(prefix) else name
        if short in _OPT_TOP:
            top[_OPT_TOP[short]] = _owned(t, dtype)
        elif short == "lm_head.weight" or name == "lm_head.weight":
            continue  # OPT ties lm_head to the embeddings
        elif short.startswith("layers."):
            idx, leaf = short[len("layers."):].split(".", 1)
            entry = _OPT_LAYER_MAP.get(leaf)
            if entry is None or int(idx) >= L:
                unmapped.append(name)
                continue
            key, transpose = entry
            per_layer[key][int(idx)] = t.T if transpose else t
        else:
            unmapped.append(name)
    missing = _missing_layers(per_layer) + [
        k for k in _OPT_TOP.values() if k not in top]
    _check_missing(path, missing, unmapped)
    return {
        "embed": top["embed"],
        "pos_embed": top["pos_embed"],
        "final_ln_w": top["final_ln_w"],
        "final_ln_b": top["final_ln_b"],
        "layers": {k: _stacked(v, dtype, cut, ("layers", k))
                   for k, v in per_layer.items()},
    }


# --------------------------------------------------------------------- #
# Mixtral (MoE)
# --------------------------------------------------------------------- #

_MIXTRAL_LAYER_MAP = {
    "input_layernorm.weight": ("attn_norm", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "block_sparse_moe.gate.weight": ("router", True),
}
_EXPERT_MAP = {"w1": "w_gate", "w3": "w_up", "w2": "w_down"}


def _load_mixtral(cfg: ModelConfig, path: str, cut) -> Dict:
    L, E, dtype = cfg.num_layers, cfg.num_experts, cfg.torch_dtype
    per_layer: Dict[str, List] = {
        key: [None] * L for key, _ in _MIXTRAL_LAYER_MAP.values()}
    experts: Dict[str, List] = {
        k: [[None] * E for _ in range(L)] for k in _EXPERT_MAP.values()}
    top: Dict[str, torch.Tensor] = {}
    unmapped: List[str] = []
    for name, t in _iter_checkpoint_tensors(path):
        if name == "model.embed_tokens.weight":
            top["embed"] = _owned(t, dtype)
        elif name == "model.norm.weight":
            top["final_norm"] = _owned(t, dtype)
        elif name == "lm_head.weight":
            top["lm_head"] = _owned(cut(("lm_head",), t.T), dtype)
        elif name.startswith("model.layers."):
            idx, leaf = name[len("model.layers."):].split(".", 1)
            i = int(idx)
            if leaf.startswith("block_sparse_moe.experts."):
                parts = leaf.split(".")
                e, w = int(parts[2]), _EXPERT_MAP.get(parts[3])
                if w is None or i >= L or e >= E:
                    unmapped.append(name)
                    continue
                experts[w][i][e] = t.T
                continue
            entry = _MIXTRAL_LAYER_MAP.get(leaf)
            if entry is None or i >= L:
                unmapped.append(name)
                continue
            key, transpose = entry
            per_layer[key][i] = t.T if transpose else t
        else:
            unmapped.append(name)
    missing = _missing_layers(per_layer) + [
        f"experts.{k}[{i}][{e}]" for k, rows in experts.items()
        for i, row in enumerate(rows) for e, leaf in enumerate(row)
        if leaf is None] + [
        k for k in ("embed", "final_norm", "lm_head") if k not in top]
    _check_missing(path, missing, unmapped)
    layers = {k: _stacked(v, dtype, cut, ("layers", k))
              for k, v in per_layer.items()}
    for k, rows in experts.items():  # [L, E, in, out]
        layers[k] = _stacked(rows, dtype, cut, ("layers", k))
    return {"embed": top["embed"], "final_norm": top["final_norm"],
            "layers": layers, "lm_head": top["lm_head"]}


def load_checkpoint(cfg: ModelConfig, path: str, rank: int = 0, tp: int = 1,
                    whole: Tuple[str, ...] = (),
                    layers: Optional[range] = None) -> Dict:
    """Load the HF weights at ``path`` into the architecture's parameter
    tree (CPU tensors in ``cfg``'s dtype). With ``tp > 1`` only rank
    ``rank``'s slice of each leaf (``parallel/sharding.py``) is copied
    out of the mapped files, except the layer leaves named in ``whole``,
    which are read whole (an int8 row-parallel leaf is quantized whole
    before it is sliced). ``layers`` (a pipeline stage's) keeps only
    those layers of the stacked leaves; every layer must still be in
    the checkpoint."""
    loader = {"llama": _load_llama, "opt": _load_opt,
              "mixtral": _load_mixtral}[cfg.arch]
    logger.info("Loading %s checkpoint from %s", cfg.arch, path)

    def cut(key, view):
        if tp == 1 or key[-1] in whole:
            return view
        if isinstance(view, list):  # one layer's experts
            n = len(view) // tp
            return view[rank * n:(rank + 1) * n]
        return slice_leaf(key, view, cfg, rank, tp)

    cut.layers = layers
    return loader(cfg, path, cut)


def hf_tensors(params: Dict, cfg: ModelConfig
               ) -> Iterator[Tuple[str, torch.Tensor]]:
    """The inverse of :func:`load_checkpoint` for a float tree: each leaf
    under its HF name, per layer (and expert) and back in HF's ``[out,
    in]`` layout, as views of ``params``."""
    layers = params["layers"]
    if cfg.arch == "opt":
        top = {v: k for k, v in _OPT_TOP.items()}
        for key in ("embed", "pos_embed"):
            yield "model.decoder." + top[key], params[key]
        for i in range(cfg.num_layers):
            for hf, (key, transpose) in _OPT_LAYER_MAP.items():
                t = layers[key][i]
                yield f"model.decoder.layers.{i}.{hf}", t.T if transpose else t
        for key in ("final_ln_w", "final_ln_b"):
            yield "model.decoder." + top[key], params[key]
        return
    layer_map = (_MIXTRAL_LAYER_MAP if cfg.arch == "mixtral"
                 else _LLAMA_LAYER_MAP)
    yield "model.embed_tokens.weight", params["embed"]
    for i in range(cfg.num_layers):
        for hf, (key, transpose) in layer_map.items():
            t = layers[key][i]
            yield f"model.layers.{i}.{hf}", t.T if transpose else t
        if cfg.arch == "mixtral":
            for w, key in _EXPERT_MAP.items():
                for e in range(cfg.num_experts):
                    yield (f"model.layers.{i}.block_sparse_moe.experts.{e}."
                           f"{w}.weight", layers[key][i, e].T)
    yield "model.norm.weight", params["final_norm"]
    if "lm_head" in params:
        yield "lm_head.weight", params["lm_head"].T


def hf_config(cfg: ModelConfig) -> Dict:
    """The HF ``config.json`` fields that ``models/config.py`` reads back
    into ``cfg`` (its dtype aside)."""
    out = {"model_type": cfg.arch, "vocab_size": cfg.vocab_size,
           "hidden_size": cfg.hidden_size,
           "num_hidden_layers": cfg.num_layers,
           "num_attention_heads": cfg.num_heads,
           "num_key_value_heads": cfg.num_kv_heads,
           "head_dim": cfg.head_dim,
           "max_position_embeddings": cfg.max_position,
           "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
           "tie_word_embeddings": cfg.tie_word_embeddings,
           "torch_dtype": cfg.dtype}
    if cfg.arch == "opt":
        out.update(ffn_dim=cfg.intermediate_size,
                   word_embed_proj_dim=cfg.hidden_size,
                   do_layer_norm_before=cfg.do_layer_norm_before)
    else:
        out["intermediate_size"] = cfg.intermediate_size
    if cfg.arch == "mixtral":
        out.update(num_local_experts=cfg.num_experts,
                   num_experts_per_tok=cfg.experts_per_token)
    return out


def save_checkpoint(params: Dict, cfg: ModelConfig, path: str,
                    shards: int = 1, torch_bin: bool = False) -> int:
    """Write ``params`` (a float tree of ``cfg``) as an HF checkpoint
    directory: ``config.json`` and the tensors under their HF names, in
    ``shards`` safetensors files split by tensor order, or one
    ``pytorch_model.bin``. Returns the tensor bytes written."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f, indent=1)
    tensors = dict(hf_tensors(params, cfg))
    nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
    if torch_bin:
        torch.save({k: t.detach().contiguous().cpu()
                    for k, t in tensors.items()},
                   os.path.join(path, "pytorch_model.bin"))
        return nbytes
    names, start = list(tensors), 0
    for n in range(shards):
        # Shard n ends where the running byte count passes its share.
        end, acc = start, 0
        while end < len(names) and (n == shards - 1 or acc < nbytes / shards):
            t = tensors[names[end]]
            acc += t.numel() * t.element_size()
            end += 1
        save_safetensors(
            {k: tensors[k] for k in names[start:end]},
            os.path.join(path, f"model-{n + 1:05d}-of-{shards:05d}"
                               ".safetensors"), {"format": "pt"})
        start = end
    return nbytes


def has_checkpoint(path: str) -> bool:
    """True for a local directory holding safetensors or torch shards."""
    return os.path.isdir(path) and (
        bool(glob.glob(os.path.join(path, "*.safetensors")))
        or bool(glob.glob(os.path.join(path, "pytorch_model*.bin"))))
