"""Disaggregated prefill between servers in this process: two port
servers (P and D) and the JAX server, tiny-llama at float32 on the JAX
engine's weights.

- ``POST /kv/pull`` on D from P over both rungs (``host``: TKV2 from P's
  ``/kv/extract``; ``auto``: P is a local peer, card to card), after which
  D serves the prompt as a prefix hit and gives P's own prefix-hit
  stream;
- host-relay pulls between the JAX server and a port server, both ways;
- 503 with ``Retry-After`` past ``--kv-pull-max-concurrency``;
- ``/kv/prepare_pull`` and ``kv_path: "device"`` answer 501;
- ``/kv/extract`` (404 without a cached block) into ``/kv/inject`` (400
  on a bad payload), and the ``tpu:kv_transfer_*`` series moving."""

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import EngineCore
from production_stack_tpu_torch.engine.server import build_server
from production_stack_tpu_torch.models.convert import params_from_numpy
from test_torch_engine import cfg_model
from test_torch_n_sampling import CFG, ServerPair

torch.set_num_threads(1)

BS = CFG["block_size"]  # 8


class Servers(ServerPair):
    """The JAX server and port server P (``ServerPair``) plus port server
    D on the same weights, which admits one pull at a time."""

    def __init__(self):
        super().__init__()
        tree = jax.tree.map(np.asarray, self.jax.core.params)
        cfg = EngineConfig(device="cpu", **CFG)
        core = EngineCore(cfg, params=params_from_numpy(
            tree, cfg_model(cfg), "cpu"))
        self.d_httpd, self.d_core = build_server(
            ["tiny-llama", "--device", "cpu", "--host", "127.0.0.1",
             "--port", "0", "--kv-pull-max-concurrency", "1"], core=core)
        self.d_thread = threading.Thread(target=self.d_httpd.serve_forever,
                                         daemon=True)
        self.d_thread.start()
        self.d = f"http://127.0.0.1:{self.d_httpd.server_address[1]}"

    def stop(self):
        self.d_httpd.shutdown()
        self.d_httpd.server_close()
        self.d_core.stop()
        self.d_thread.join(timeout=10)
        super().stop()


@pytest.fixture(scope="module")
def srv():
    s = Servers()
    yield s
    s.stop()


def _post(base, path, body, expect=200):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, raw, headers = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        status, raw, headers = e.code, e.read(), e.headers
    assert status == expect, raw[:300]
    return raw, headers


def _complete(base, ids, max_tokens=8):
    raw, _ = _post(base, "/v1/completions", {
        "prompt": ids, "max_tokens": max_tokens, "temperature": 0.0})
    return json.loads(raw)["choices"][0]["text"]


def _pull(base, source, ids, kv_path, expect=200):
    raw, headers = _post(base, "/kv/pull", {
        "source_url": source, "request": {"prompt": ids},
        "kv_path": kv_path}, expect)
    return json.loads(raw), headers


def _ids(start):
    return list(range(start, start + 5 * BS + 1))  # 5 full blocks + 1


@pytest.mark.parametrize("kv_path,rung", [("host", "host"),
                                          ("auto", "local-device")])
def test_pull_between_port_servers(srv, kv_path, rung):
    ids = _ids(10 if kv_path == "host" else 100)
    _complete(srv.port, ids, max_tokens=1)  # P prefills, as a prefiller
    cached = srv.d_core.cached_tokens_total
    out, _ = _pull(srv.d, srv.port, ids, kv_path)
    assert out["status"] == "ok" and out["injected_blocks"] == 5
    assert out["transfer"]["path"] == rung
    assert out["transfer"]["bytes"] > 0
    got = _complete(srv.d, ids)
    assert srv.d_core.cached_tokens_total - cached == 5 * BS
    assert got == _complete(srv.port, ids)  # P's own prefix-hit stream


def test_host_relay_from_jax_into_port(srv):
    ids = _ids(200)
    _complete(srv.ref, ids, max_tokens=1)
    out, _ = _pull(srv.d, srv.ref, ids, "host")
    assert out["transfer"]["path"] == "host"
    assert out["injected_blocks"] == 5
    assert _complete(srv.d, ids) == _complete(srv.ref, ids)


def test_host_relay_from_port_into_jax(srv):
    ids = _ids(300)
    _complete(srv.port, ids, max_tokens=1)
    out, _ = _pull(srv.ref, srv.port, ids, "host")
    assert out["transfer"]["path"] == "host"
    assert out["injected_blocks"] == 5
    assert _complete(srv.ref, ids) == _complete(srv.port, ids)


def test_pull_misses_without_a_cached_prefix(srv):
    out, _ = _pull(srv.d, srv.port, _ids(400), "host")
    assert out == {"status": "miss", "injected_blocks": 0}


class _SlowSource(BaseHTTPRequestHandler):
    release = threading.Event()
    arrived = threading.Event()

    def do_POST(self):  # noqa: N802 - http.server API
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        _SlowSource.arrived.set()
        _SlowSource.release.wait(30)
        self.send_response(404)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *args):
        pass


def test_pull_admission_answers_503_past_the_cap(srv):
    slow = ThreadingHTTPServer(("127.0.0.1", 0), _SlowSource)
    threading.Thread(target=slow.serve_forever, daemon=True).start()
    source = f"http://127.0.0.1:{slow.server_address[1]}"
    first = {}
    th = threading.Thread(target=lambda: first.update(
        _pull(srv.d, source, _ids(500), "host")[0]))
    try:
        th.start()
        assert _SlowSource.arrived.wait(30)
        out, headers = _pull(srv.d, source, _ids(500), "host", expect=503)
        assert out["status"] == "rejected"
        assert headers["Retry-After"] == "1"
        metrics = urllib.request.urlopen(srv.d + "/metrics").read().decode()
        assert 'tpu:kv_pull_inflight{model_name="tiny-llama"} 1' in metrics
    finally:
        _SlowSource.release.set()
        th.join(timeout=60)
        slow.shutdown()
        slow.server_close()
    assert first == {"status": "miss", "injected_blocks": 0}
    metrics = urllib.request.urlopen(srv.d + "/metrics").read().decode()
    assert 'tpu:kv_pull_rejected_total{model_name="tiny-llama"} 1' in metrics


def test_device_path_and_prepare_pull_answer_501(srv):
    _post(srv.d, "/kv/prepare_pull", {"prompt": _ids(10)}, expect=501)
    out, _ = _pull(srv.d, srv.port, _ids(10), "device", expect=501)
    assert "unavailable" in out["error"]
    raw, _ = _post(srv.d, "/kv/release", {"uuid": 1})
    assert json.loads(raw) == {"status": "ok"}


def test_extract_into_inject_over_http(srv):
    _post(srv.d, "/kv/extract", {"prompt": _ids(600)}, expect=404)
    ids = _ids(700)
    _complete(srv.port, ids, max_tokens=1)
    payload, headers = _post(srv.port, "/kv/extract", {"token_ids": ids})
    assert headers["X-KV-Tokens"] == str(5 * BS)
    req = urllib.request.Request(
        srv.d + "/kv/inject", data=payload,
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        out = json.loads(resp.read())
    assert out == {"status": "ok", "injected_blocks": 5,
                   "num_tokens": 5 * BS}
    req = urllib.request.Request(srv.d + "/kv/inject", data=payload[:-3])
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=60)
    assert err.value.code == 400


def test_transfer_series_move(srv):
    def series(base):
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        out = {}
        for line in text.splitlines():
            if line.startswith("tpu:kv_") or line.startswith("tpu:prefix_"):
                name, value = line.rsplit(" ", 1)
                out[name.split("{")[0] + name[name.index("}") + 1:]
                    if "tier" not in name else name] = float(value)
        return out

    ids = _ids(800)
    _complete(srv.port, ids, max_tokens=1)
    p0, d0 = series(srv.port), series(srv.d)
    _pull(srv.d, srv.port, ids, "host")
    _pull(srv.d, srv.port, _ids(900), "auto")  # a miss on the device rung
    p1, d1 = series(srv.port), series(srv.d)
    assert p1["tpu:kv_transfer_tx_bytes_total"] > p0[
        "tpu:kv_transfer_tx_bytes_total"]
    assert d1["tpu:kv_transfer_rx_bytes_total"] > d0[
        "tpu:kv_transfer_rx_bytes_total"]
    assert d1["tpu:kv_transfer_rx_seconds_total"] > d0[
        "tpu:kv_transfer_rx_seconds_total"]
    assert d1["tpu:kv_transfer_pulls_total"] == d0[
        "tpu:kv_transfer_pulls_total"] + 1
    assert "tpu:kv_transfer_device_pulls_total" in d1
    assert 'tpu:kv_page_occupancy{model_name="tiny-llama",tier="offload"}' \
        in d1
