"""A new configuration, traffic mix or metric is new files and new
entries: the harness finds each by its name, and no file that was there
changes."""

import hashlib
import json
import os

from portbench import spec
from portbench.tests.tinybench import REPO, make_root


def digest(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = make_root(str(tmp_path))
    before = digest(root)
    with open(os.path.join(root, "portbench", "traffic",
                           "burst-new.json"), "w") as f:
        json.dump({"loop": "open", "rate_rps": 2.0,
                   "prompt": {"dist": "constant", "value": 32},
                   "answer": {"dist": "constant", "value": 8},
                   "system_prompt_tokens": 64}, f)
    with open(os.path.join(root, "portbench", "configs", "new.json"),
              "w") as f:
        json.dump(dict(json.load(open(os.path.join(
            root, "portbench", "configs", "tiny.json"))),
            num_hidden_layers=3), f)
    with open(os.path.join(root, "portbench", "metrics",
                           "requests_in_window.py"), "w") as f:
        f.write("def read(run):\n    return len(run.window_requests())\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "new", "source": "toy",
                             "file": "portbench/configs/new.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new.burst", "config": "new",
                               "traffic": "burst-new", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "requests_in_window", "unit": "1",
                               "better": "higher",
                               "source": "host_clock", "layer": "x",
                               "moves": "ttft_p90_s",
                               "workloads": ["new.burst"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = spec.load_cell(root, "new.burst")
    assert cell.shape.layers == 3
    assert cell.traffic["system_prompt_tokens"] == 64
    assert "requests_in_window" in [m["name"] for m in cell.per_layer]
    # output_tok_s lists its cells: the new one does not report it.
    assert "output_tok_s" not in [m["name"] for m in cell.end_to_end]
    reader = spec.metric_reader(root, "requests_in_window")

    class Run:
        def window_requests(self):
            return [1, 2, 3]

    assert reader(Run()) == 3
    after = digest(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_metric_of_the_benchmark_has_its_reader():
    bench = spec.load_benchmark(REPO)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(REPO, m["name"])), m["name"]
    for w in bench["workloads"]:
        cell = spec.load_cell(REPO, w["name"])
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
