"""The torch port's OpenAI server on tiny-llama / CPU: completions and chat,
plain and streamed, /health, /v1/models, n > 1 and structured output
accepted, the refusals (an uncompilable grammar among them), and a /metrics
page that the router's own scraper parses."""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from production_stack_tpu.router.engine_stats import EngineStats
from production_stack_tpu_torch.engine.server import build_server

torch.set_num_threads(1)

ARGS = ["tiny-llama", "--device", "cpu", "--host", "127.0.0.1", "--port",
        "0", "--max-model-len", "256", "--block-size", "4", "--num-blocks",
        "128", "--dtype", "float32", "--max-loras", "2"]


@pytest.fixture(scope="module")
def server():
    httpd, core = build_server(ARGS)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", core
    httpd.shutdown()
    httpd.server_close()
    core.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(base, path, body, raw=False):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200
        text = resp.read().decode()
    return text if raw else json.loads(text)


def _events(text):
    lines = [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]
    assert lines[-1] == "[DONE]"
    return [json.loads(ln) for ln in lines[:-1]]


def test_completion_plain_and_streamed_agree(server):
    base, _ = server
    body = {"prompt": "hello world", "max_tokens": 6, "temperature": 0}
    out = _post(base, "/v1/completions", body)
    choice = out["choices"][0]
    assert out["object"] == "text_completion"
    assert choice["finish_reason"] == "length"
    assert out["usage"] == {"prompt_tokens": 12, "completion_tokens": 6,
                            "total_tokens": 18}
    events = _events(_post(base, "/v1/completions", dict(body, stream=True),
                           raw=True))
    assert events[-1]["choices"][0]["finish_reason"] == "length"
    streamed = "".join(e["choices"][0]["text"] for e in events)
    assert streamed == choice["text"]


def test_chat_plain_and_streamed(server):
    base, _ = server
    body = {"messages": [{"role": "user", "content": "hi there"}],
            "max_tokens": 5, "temperature": 0, "logprobs": True,
            "top_logprobs": 2}
    out = _post(base, "/v1/chat/completions", body)
    choice = out["choices"][0]
    assert out["object"] == "chat.completion"
    assert choice["message"]["role"] == "assistant"
    assert len(choice["logprobs"]["content"]) == 5
    assert len(choice["logprobs"]["content"][0]["top_logprobs"]) == 2
    events = _events(_post(base, "/v1/chat/completions",
                           dict(body, stream=True), raw=True))
    assert events[0]["object"] == "chat.completion.chunk"
    assert events[0]["choices"][0]["delta"]["role"] == "assistant"
    text = "".join(e["choices"][0]["delta"].get("content", "")
                   for e in events)
    assert text == choice["message"]["content"]
    assert events[-1]["choices"][0]["finish_reason"] == "length"


def test_seeded_sampled_chat_repeats(server):
    base, _ = server
    body = {"messages": [{"role": "user", "content": "tell me"}],
            "max_tokens": 8, "temperature": 0.8, "seed": 5, "stream": True}
    runs = [_events(_post(base, "/v1/chat/completions", body, raw=True))
            for _ in range(2)]
    texts = ["".join(e["choices"][0]["delta"].get("content", "")
                     for e in ev) for ev in runs]
    assert texts[0] == texts[1]


def test_health_models_and_refusals(server):
    base, _ = server
    with urllib.request.urlopen(base + "/health", timeout=10) as resp:
        assert resp.status == 200
    with urllib.request.urlopen(base + "/v1/models", timeout=10) as resp:
        assert json.loads(resp.read())["data"][0]["id"] == "tiny-llama"
    # n > 1 and structured output are served since they were ported.
    out = _post(base, "/v1/completions",
                {"prompt": "x", "n": 2, "max_tokens": 3, "seed": 1})
    assert [c["index"] for c in out["choices"]] == [0, 1]
    out = _post(base, "/v1/completions",
                {"prompt": "x", "guided_regex": "[0-9]{2}", "max_tokens": 8,
                 "temperature": 0})
    assert len(out["choices"][0]["text"]) == 2
    assert out["choices"][0]["text"].isdigit()
    for body, code in [
            ({"prompt": "x", "guided_regex": "(a"}, 400),  # uncompilable
            ({"prompt": "x", "guided_json": {"not": {"type": "string"}}},
             400),
            ({"prompt": "x", "max_tokens": "5"}, 400),
            ({"prompt": "x" * 300}, 400),  # over max_model_len
            ({"prompt": "x", "model": "other"}, 404)]:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base, "/v1/completions", body)
        assert err.value.code == code, body


def test_metrics_parse_with_the_router_scraper(server):
    base, core = server
    _post(base, "/v1/completions",
          {"prompt": "shared prefix text " * 3, "max_tokens": 2})
    _post(base, "/v1/completions",
          {"prompt": "shared prefix text " * 3 + "more", "max_tokens": 2})
    with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
        text = resp.read().decode()
    for series in ("vllm:num_requests_running", "vllm:num_requests_waiting",
                   "vllm:gpu_cache_usage_perc", "tpu:hbm_kv_usage_perc",
                   "vllm:gpu_prefix_cache_hits_total",
                   "vllm:gpu_prefix_cache_queries_total",
                   "tpu:prefix_cache_hits_total",
                   "tpu:prefix_cache_queries_total",
                   "tpu:hbm_headroom_bytes"):
        assert series + "{" in text, series
    stats = EngineStats.from_vllm_scrape(text)
    s = core.stats()
    assert stats.num_running_requests == 0
    assert stats.num_queuing_requests == 0
    assert stats.gpu_prefix_cache_hits == s["prefix_cache_hits"] > 0
    assert stats.gpu_prefix_cache_queries == s["prefix_cache_queries"]
    assert stats.gpu_cache_usage_perc == pytest.approx(s["kv_usage"],
                                                       abs=1e-6)
    assert stats.hbm_headroom_bytes == 0.0  # no device memory figure on CPU
