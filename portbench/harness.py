"""One run of one cell: the port's OpenAI server on the card, the load
from a child process, the window, the metrics and the output check.

The steps, in order:

1. weights drawn from ``--seed`` on the card (``weights.py``), handed to
   ``EngineCore(config, params=...)`` built from the configuration's
   ``engine_args`` by the server's own argument parser, the model's
   ``config.json`` written from the configuration file;
2. ``build_server(argv, core=...)``: the engine's warm-up, then the
   socket on 127.0.0.1 at a free port;
3. the client (``client.py``) started; the traffic starts, ramps for the
   mix's ``ramp_s``, and the window is measured for ``seconds``
   (``torch.profiler`` over it in a traced run);
4. after the grace the client cuts what is still streaming; spans,
   counters and step records are read, the peak memory taken, the
   server stopped and the program's state freed;
5. the output check (``reference/check.py``) and the result line.

The benchmark's own record of what was served: the token ids the engine
hands to each request's stream and the time it does so, taken by a
wrapper around ``EngineCore.add_request``'s callback (the server streams
text, from which the ids of a byte tokenizer cannot be read back).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import torch

from portbench import devtrace, spec, traffic, weights
from portbench.reference import check

FORBIDDEN = ("jax", "jaxlib", "flax", "production_stack_tpu")
# After the grace ends and the engine has stopped, the client waits this
# long for the aborted streams to end before it cuts what is left.
CUT_S = 2.0
HERE = os.path.dirname(os.path.abspath(__file__))


def process_start_time() -> float:
    """This process's start on ``time.time()``'s clock (from /proc; the
    time of the call where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile over all values."""
    v = sorted(values)
    k = max(0, min(len(v) - 1, int(-(-q * len(v) // 100)) - 1))
    return v[k]


class TokenLog:
    """The ids and times of the tokens the engine hands to each
    request's stream."""

    def __init__(self):
        self.tokens: Dict[str, tuple] = {}

    def wrap(self, core) -> None:
        add = core.add_request
        log = self.tokens

        def add_request(request_id, prompt_token_ids, sampling, on_token,
                        *args, **kwargs):
            ids, times = [], []
            log[request_id] = (ids, times)

            def cb(token, finish):
                if token is not None:
                    times.append(time.time())
                    ids.append(int(token[0] if isinstance(token, tuple)
                                   else token))
                on_token(token, finish)

            return add(request_id, prompt_token_ids, sampling, cb, *args,
                       **kwargs)

        core.add_request = add_request


@dataclasses.dataclass
class Run:
    """What a metric reader (``metrics/<name>.py``) reads."""
    cell: spec.Cell
    shape: spec.Shape
    seconds: float
    t_open: float
    t_close: float
    t_end: float
    setup_s: float
    block: int
    chunk: int
    requests: List[dict]
    stats0: dict
    stats1: dict
    steps: List[dict]
    trace: Optional[devtrace.DeviceTrace] = None
    # The traced window (the profiler's start to its stop).
    dev_open: float = 0.0
    dev_close: float = 0.0

    def in_window(self, t: Optional[float]) -> bool:
        return t is not None and self.t_open <= t < self.t_close

    def window_requests(self) -> List[dict]:
        return [r for r in self.requests if r["in_window"]]

    def delta(self, key: str) -> float:
        return self.stats1[key] - self.stats0[key]

    def output_tokens_in_window(self) -> int:
        return sum(1 for r in self.requests for t in r["token_times"]
                   if self.in_window(t))

    def window_steps(self, kinds) -> List[dict]:
        return [s for s in self.steps
                if s["kind"] in kinds and self.in_window(s["start"])]


def _engine_flag(args: List[str], flag: str, default: int) -> int:
    if flag in args:
        return int(args[args.index(flag) + 1])
    return default


def _client(port: int, model: str, mix: dict, seed: int, vocab: int,
            seconds: float):
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "client.py")],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    proc.stdin.write(json.dumps({"port": port, "model": model, "mix": mix,
                                 "seed": seed, "vocab": vocab,
                                 "seconds": seconds, "cut_s": CUT_S})
                     + "\n")
    proc.stdin.flush()
    line = proc.stdout.readline()
    if line.strip() != "ready":
        proc.kill()
        proc.wait()
        raise RuntimeError(f"client failed to start: {line!r}")
    return proc


def _finished(r: dict) -> bool:
    return (r["finish"] == "length" and r["done"] and r["error"] is None
            and len(r["served"]) == r["max_tokens"])


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             control: bool = False, check_output: bool = True,
             inspect=None, log=sys.stderr) -> dict:
    """One run; returns the result (the last line's object, before the
    forbidden-module check) with the compared numbers under ``check``.
    With ``control`` it also reads the control and the bfloat16 witness
    at the same positions (``readings``), and the control's verdict
    under the same limits (``control_correct``)."""
    t_start = t_start if t_start is not None else time.time()
    from production_stack_tpu_torch.engine import server as srv
    from production_stack_tpu_torch.engine.core import EngineCore

    shape = cell.shape
    cfg = cell.config
    dtype = getattr(torch, shape.dtype)
    dev = torch.device(device)
    mix = cell.traffic
    engine_args = list(cfg.get("engine_args", []))
    block = _engine_flag(engine_args, "--block-size", 64)
    chunk = _engine_flag(engine_args, "--prefill-chunk-size", 1024)

    work = tempfile.mkdtemp(prefix="portbench-")
    model_dir = os.path.join(work, "model")
    os.makedirs(model_dir)
    hf = {k: v for k, v in cfg.items()
          if k not in ("engine_args", "assumed", "check", "published")}
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(hf, f)

    marks = [("start", time.time())]
    params = weights.draw_params(shape, seed, dtype, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks.append(("weights", time.time()))
    argv = [model_dir, "--host", "127.0.0.1", "--port", "0", "--device",
            device, "--served-model-name", cell.config_name,
            "--trace-buffer", "100000", "--step-record-capacity", "100000",
            "--seed", str(seed % (2 ** 31))] + engine_args
    args = srv.build_arg_parser().parse_args(argv)
    core = EngineCore(srv.config_from_args(args), params=params)
    del params
    marks.append(("engine", time.time()))
    tokens = TokenLog()
    tokens.wrap(core)
    httpd, core = srv.build_server(argv, core=core)
    marks.append(("warmup", time.time()))
    serve = threading.Thread(target=httpd.serve_forever, daemon=True)
    serve.start()
    port = httpd.server_address[1]
    tracer = devtrace.Tracer(dev) if trace else None
    client = None
    try:
        client = _client(port, cell.config_name, mix, seed, shape.vocab,
                         seconds)
        t0 = time.time() + 0.05
        client.stdin.write(f"go {t0!r}\n")
        client.stdin.flush()
        setup_s = t0 - t_start
        marks.append(("client", t0))
        print("setup " + " ".join(
            f"{name} {t - prev:.3f}" for (name, t), (_, prev) in
            zip(marks, [("", t_start)] + marks[:-1])), file=log)
        t_open = t0 + float(mix.get("ramp_s", 0))
        t_close = t_open + seconds
        t_end = t_close + float(mix.get("grace_s", 10))
        wait_until(t_open)
        stats0 = core.stats()
        if tracer:
            tracer.start()
        tr_open = time.time()
        wait_until(t_close)
        tr_close = time.time()
        if tracer:
            tracer.stop()
        stats1 = core.stats()
        # The grace's end: the engine stops, then every request still
        # open is aborted (its stream ends), with no step running.
        wait_until(t_end)
        core.stop()
        for rid in list(tokens.tokens):
            core.abort_request(rid)
        out, _ = client.communicate(timeout=CUT_S + 120)
        client = None
        records = json.loads(out.strip().splitlines()[-1])
        dev_trace = tracer.result(tr_open, tr_close) if tracer else None
        rec = httpd.engine.trace_recorder
        steps = []
        if core.step_recorder is not None:
            for s in core.step_recorder.snapshot():
                steps.append(dict(s, start=s["ts_unix"] - s["wall_s"],
                                  end=s["ts_unix"]))
        spans = {}
        for r in records:
            t = rec.get(r["rid"])
            if t is not None:
                spans[r["rid"]] = {s["name"]: s for s in
                                   (x.to_dict() for x in t.spans)}
        memory_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)
    finally:
        if client is not None:
            client.kill()
            client.wait()
        httpd.shutdown()
        httpd.server_close()
        core.stop()
        serve.join(timeout=30)
    del httpd, core
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    sched = traffic.build(mix, seed, shape.vocab, seconds)
    by_rid = {q.rid: q for q in sched.requests}
    order = sorted(records, key=lambda r: r["send"])
    prompts = {r["rid"]: sched.prompt_ids(by_rid[r["rid"]]) for r in order}
    shared = traffic.shared_prefix_tokens([prompts[r["rid"]] for r in order],
                                          block)
    requests = []
    for r, sh in zip(order, shared):
        q = by_rid[r["rid"]]
        ids, times = tokens.tokens.get(r["rid"], ([], []))
        sp = spans.get(r["rid"], {})
        prefill = sp.get("engine.prefill", {})
        queue_span = sp.get("engine.queue", {})
        decode = sp.get("engine.decode", {})
        start = r["due"] if r["due"] is not None else r["send"]
        requests.append(dict(
            r, prompt_len=q.prompt_len, max_tokens=q.max_tokens, shared=sh,
            served=list(ids), token_times=list(times),
            in_window=t_open <= start < t_close, start=start,
            cached=prefill.get("attributes", {}).get("cached_tokens", 0),
            arrival=queue_span.get("start_unix"),
            prefill_start=queue_span.get("end_unix") if prefill else None,
            engine_ttft=decode.get("attributes", {}).get(
                "time_to_first_token_s")))
    run = Run(cell=cell, shape=shape, seconds=seconds, t_open=t_open,
              t_close=t_close, t_end=t_end, setup_s=setup_s, block=block,
              chunk=chunk, requests=requests, stats0=stats0, stats1=stats1,
              steps=steps, trace=dev_trace, dev_open=tr_open,
              dev_close=tr_close)

    if inspect is not None:
        inspect(run)

    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in names:
        value = spec.metric_reader(cell.root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    window = run.window_requests()
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": False, "attempted": len(window),
              "failed": sum(failed(r) for r in window), "metrics": metrics,
              "device": device_info}
    if dev_trace is not None:
        device_info["busy_s"] = dev_trace.busy_s()
        device_info["window_s"] = dev_trace.window_s
        result["breakdown"] = {
            "device_ops": devtrace.top(dev_trace.by_name()),
            "idle_gaps": devtrace.label_gaps(
                dev_trace.idle_gaps(tr_open, tr_close), steps, tr_open)}

    # The output check, on the card the program has left.
    chk = cfg.get("check", {})
    finished = [dict(r, prompt=prompts[r["rid"]]) for r in requests
                if _finished(r)]
    picked = (check.sample(finished, seed, int(chk.get("sample_tokens",
                                                       512)))
              if check_output else [])
    limits = chk.get("limits", {})
    readings = {}
    margins = [] if control and shape.experts else None
    if picked:
        ref = check.reference_logits(shape, seed, picked, dev,
                                     margins=margins)
        readings = check.served_gap(ref, picked)
        if margins:
            readings.update(check.margins_at_widest(ref, picked, margins))
        if control:
            # The control (float8) and the bfloat16 witness, read as the
            # program's tokens would be.
            for precision, tag in (("fp8", "control_"), ("bf16", "bf16_")):
                other = check.reference_logits(shape, seed, picked, dev,
                                               precision=precision)
                for name, v in check.control_gap(ref, other).items():
                    readings[tag + name] = v
                del other
        del ref
    compared = {name: {"value": readings.get(name), "limit": limit}
                for name, limit in limits.items()}
    compared["finished"] = {"value": len(finished), "limit": 1}
    result["correct"] = passes(readings, limits, picked)
    result["readings"] = readings
    if control:
        # The control judged by the same limits: it has to fail them.
        ctrl = {name[len("control_"):]: v for name, v in readings.items()
                if name.startswith("control_")}
        result["control_correct"] = passes(ctrl, limits, picked)
        for name, limit in limits.items():
            print(f"control {name} {ctrl.get(name)!r} limit {limit!r}",
                  file=log)
    for name, c in compared.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=log)
    result["check"] = compared
    shutil.rmtree(work, ignore_errors=True)
    return result


def passes(readings: dict, limits: dict, picked: list) -> bool:
    """The output check's verdict: a sample was compared and every
    reading the configuration limits is at or under its limit."""
    return bool(picked) and bool(limits) and all(
        readings[name] <= limit for name, limit in limits.items())


def wait_until(t: float) -> None:
    while True:
        left = t - time.time()
        if left <= 0:
            return
        time.sleep(min(left, 0.2))


def failed(r: dict) -> bool:
    """Refused, errored, or no first token before the grace ended."""
    return r["first"] is None or bool(r["error"]) or r["status"] != 200


def ttft_values(run: Run) -> List[float]:
    """Time to first token of every window request, from when it was
    due (open loop) or sent (closed loop); a request that failed or got
    no token before the grace ended reads as the whole wait until then,
    longer than any that answered."""
    out = []
    for r in run.window_requests():
        if failed(r):
            out.append(run.t_end - r["start"])
        else:
            out.append(r["first"] - r["start"])
    return out


def tpot_values(run: Run) -> List[float]:
    """(last - first token) / (tokens - 1) of each request that finished
    in the window; a window request that failed reads as the window's
    length a token."""
    out = []
    for r in run.requests:
        n = len(r["served"])
        if (r["last"] is not None and run.in_window(r["last"]) and n > 1
                and r["error"] is None):
            out.append((r["last"] - r["first"]) / (n - 1))
    for r in run.window_requests():
        if failed(r):
            out.append(run.seconds)
    return out


def median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None
