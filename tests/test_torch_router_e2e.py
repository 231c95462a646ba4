"""The JAX package's router in front of the torch port's engine, over real
HTTP: requests route through it, streamed and not, and its engine-stats
scraper reads the port's /metrics (the router talks to the port over
HTTP only)."""

import asyncio
import json
import threading

import aiohttp
import pytest
import torch
from aiohttp import web

from production_stack_tpu.router import routing_logic as rl
from production_stack_tpu.router.app import build_app
from production_stack_tpu.router.engine_stats import (
    EngineStatsScraper,
    get_engine_stats_scraper,
)
from production_stack_tpu.router.request_stats import RequestStatsMonitor
from production_stack_tpu.utils.misc import SingletonABCMeta, SingletonMeta
from production_stack_tpu_torch.engine.server import build_server

torch.set_num_threads(1)

_SINGLETONS = (rl.RoundRobinRouter, rl.SessionRouter, rl.PrefixAwareRouter,
               rl.KvawareRouter, rl.DisaggregatedPrefillRouter)


def _reset():
    for cls in _SINGLETONS:
        SingletonABCMeta._reset_instance(cls)
    SingletonMeta._reset_instance(RequestStatsMonitor)
    SingletonMeta._reset_instance(EngineStatsScraper)


@pytest.fixture
def torch_engine():
    _reset()
    httpd, core = build_server([
        "tiny-llama", "--device", "cpu", "--host", "127.0.0.1", "--port",
        "0", "--max-model-len", "256", "--block-size", "4", "--num-blocks",
        "128", "--dtype", "float32", "--max-loras", "2", "--no-warmup"])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    core.stop()
    _reset()


async def test_router_serves_and_scrapes_the_torch_engine(torch_engine):
    from production_stack_tpu.router.parser import build_parser

    args = build_parser().parse_args([])
    for k, v in dict(static_backends=torch_engine, static_models="tiny-llama",
                     routing_logic="roundrobin",
                     engine_stats_interval=0.2).items():
        setattr(args, k, v)
    runner = web.AppRunner(build_app(args))
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    router = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
    try:
        async with aiohttp.ClientSession() as s:
            body = {"model": "tiny-llama", "max_tokens": 4, "temperature": 0,
                    "messages": [{"role": "user", "content": "hi"}]}
            async with s.post(f"{router}/v1/chat/completions",
                              json=body) as resp:
                assert resp.status == 200
                out = await resp.json()
                assert out["choices"][0]["finish_reason"] == "length"
                assert out["usage"]["completion_tokens"] == 4
            async with s.post(f"{router}/v1/chat/completions",
                              json=dict(body, stream=True)) as resp:
                assert resp.status == 200
                chunks = []
                async for line in resp.content:
                    line = line.decode().strip()
                    if line.startswith("data: ") and line != "data: [DONE]":
                        chunks.append(json.loads(line[6:]))
                text = "".join(c["choices"][0]["delta"].get("content", "")
                               for c in chunks)
                assert text == out["choices"][0]["message"]["content"]
                assert chunks[-1]["choices"][0]["finish_reason"] == "length"
        # The scraper thread has parsed the port's /metrics. A scrape taken
        # while the streamed request still ran reads it as running, so
        # wait for one taken after both requests finished.
        for _ in range(50):
            stats = get_engine_stats_scraper().get_engine_stats()
            if torch_engine in stats and \
                    stats[torch_engine].gpu_prefix_cache_queries > 0 and \
                    stats[torch_engine].num_running_requests == 0:
                break
            await asyncio.sleep(0.1)
        got = stats[torch_engine]
        assert got.gpu_prefix_cache_queries > 0
        assert got.num_running_requests == 0
    finally:
        get_engine_stats_scraper().close()
        await runner.cleanup()
