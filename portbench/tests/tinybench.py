"""A benchmark root at toy sizes for the CPU tests: a copy of the
benchmark's data folders beside a ``BENCHMARK.json`` whose one cell runs
a two-layer model (Llama- or Mixtral-shaped) in float32 under a short
closed or open loop."""

from __future__ import annotations

import copy
import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def tiny_config(arch: str = "llama") -> dict:
    cfg = {"hidden_size": 128, "intermediate_size": 256,
           "max_position_embeddings": 2048,
           "model_type": "mixtral" if arch == "mixtral" else "mistral",
           "num_attention_heads": 4, "num_hidden_layers": 2,
           "num_key_value_heads": 2, "rms_norm_eps": 1e-5,
           "rope_theta": 10000.0, "tie_word_embeddings": False,
           "torch_dtype": "float32", "vocab_size": 512,
           "engine_args": ["--dtype", "float32", "--max-model-len", "512",
                           "--max-num-seqs", "4", "--block-size", "16",
                           "--num-blocks", "256", "--enable-prefix-caching",
                           "--enable-chunked-prefill",
                           "--prefill-chunk-size", "64",
                           "--prefill-batch", "4"],
           "check": {"sample_tokens": 48, "limits": {"max_gap": 1e-3}}}
    if arch == "mixtral":
        cfg.update(num_local_experts=4, num_experts_per_tok=2)
    return cfg


MIXES = {
    "closed": {"loop": "closed", "clients": 4, "stagger_s": 0.5,
               "requests_per_client": 64,
               "prompt": {"dist": "uniform", "min": 16, "max": 100},
               "answer": {"dist": "uniform", "min": 8, "max": 24},
               "ramp_s": 1, "grace_s": 3},
    "open": {"loop": "open", "rate_rps": 3.0,
             "docs": {"length": {"dist": "uniform", "min": 100, "max": 200},
                      "asks": {"dist": "uniform", "min": 2, "max": 3},
                      "ask_gap_s": {"dist": "exponential", "mean": 0.5}},
             "prompt": {"dist": "uniform", "min": 8, "max": 16},
             "answer": {"dist": "uniform", "min": 4, "max": 12},
             "ramp_s": 1, "grace_s": 3},
}


def make_root(tmp: str, arch: str = "llama", loop: str = "closed") -> str:
    """A benchmark root under ``tmp`` with one cell, ``tiny.<loop>``."""
    root = os.path.join(tmp, "root")
    os.makedirs(os.path.join(root, "portbench"))
    for d in ("traffic", "metrics", "configs"):
        shutil.copytree(os.path.join(REPO, "portbench", d),
                        os.path.join(root, "portbench", d))
    with open(os.path.join(root, "portbench", "configs", "tiny.json"),
              "w") as f:
        json.dump(tiny_config(arch), f)
    with open(os.path.join(root, "portbench", "traffic",
                           f"tiny-{loop}.json"), "w") as f:
        json.dump(MIXES[loop], f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench = copy.deepcopy(bench)
    bench["configs"].append({"name": "tiny", "source": "toy",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    cell = f"tiny.{loop}"
    bench["workloads"].append({"name": cell, "config": "tiny",
                               "traffic": f"tiny-{loop}", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
