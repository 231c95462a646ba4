"""Finds a cell's files by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own:

- a configuration: the file that its ``configs`` entry names (the
  published ``config.json`` keys as run, plus ``engine_args``,
  ``assumed`` and ``check``);
- a traffic mix: ``portbench/traffic/<traffic>.json``;
- a metric: ``portbench/metrics/<metric>.py``, with a ``read(run)``
  function

(all under the checkout's root, beside ``BENCHMARK.json``).

A new cell, configuration, traffic mix or metric is therefore new files
and new entries, and no edit here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

BENCH_DIR = "portbench"


@dataclasses.dataclass
class Shape:
    """The sizes of a model, read from its published ``config.json``
    keys (the names the Hugging Face configs of Mistral and Mixtral
    use)."""
    arch: str            # "llama" (dense MLP) or "mixtral" (routed MoE)
    vocab: int
    hidden: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    intermediate: int
    experts: int         # 0: dense MLP
    top_k: int
    rope_theta: float
    eps: float
    dtype: str = "bfloat16"  # the served dtype (``torch_dtype``)

    @classmethod
    def from_config(cls, cfg: dict) -> "Shape":
        heads = int(cfg["num_attention_heads"])
        hidden = int(cfg["hidden_size"])
        experts = int(cfg.get("num_local_experts", 0) or 0)
        return cls(
            arch="mixtral" if experts else "llama",
            vocab=int(cfg["vocab_size"]), hidden=hidden,
            layers=int(cfg["num_hidden_layers"]), heads=heads,
            kv_heads=int(cfg.get("num_key_value_heads", heads)),
            head_dim=int(cfg.get("head_dim") or hidden // heads),
            intermediate=int(cfg["intermediate_size"]), experts=experts,
            top_k=int(cfg.get("num_experts_per_tok", 2)),
            rope_theta=float(cfg.get("rope_theta", 10000.0)),
            eps=float(cfg.get("rms_norm_eps", 1e-5)),
            dtype=str(cfg.get("torch_dtype", "bfloat16")))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    run_seconds: int
    root: str

    @property
    def shape(self) -> Shape:
        return Shape.from_config(self.config)


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_cells: Dict[str, List[str]]):
    """Whether ``metric`` belongs in ``cell``'s line: its ``workloads``
    where it has them; else every cell that reports the end-to-end
    metric it moves (an end-to-end metric: every cell unless listed)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    if moves is None or moves not in e2e_cells:
        return True
    return cell in e2e_cells[moves]


def load_cell(root: str, name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of the benchmark at ``root``, with its
    configuration and traffic files read and the metrics it reports."""
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, BENCH_DIR, "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    all_cells = [c["name"] for c in bench["workloads"]]
    e2e_cells = {m["name"]: m.get("workloads", all_cells)
                 for m in bench["end_to_end"]}
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, e2e_cells)]
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_cells)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic_name=w["traffic"], traffic=traffic,
                end_to_end=e2e, per_layer=per_layer,
                run_seconds=int(bench["run_seconds"]), root=root)


def metric_reader(root: str, name: str) -> Callable:
    """``read(run)`` of ``portbench/metrics/<name>.py`` (file names keep
    the metric's dots, so the file is loaded by path)."""
    path = os.path.join(root, BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
