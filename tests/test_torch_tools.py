"""Tools on the torch port: its own copy of ``engine/tools.py`` against the
JAX module on the cases of ``tests/test_tools.py``, and chat with
``tools`` / ``tool_choice`` through the port's standard-library server
against the JAX server on the same weights (``test_torch_n_sampling``'s
``ServerPair``): the same preamble (prompt tokens), messages, finish
reasons and streamed deltas. A guided regex that spells out a hermes
``<tool_call>`` block makes random weights emit one, so the parsed-call
path runs end to end as well."""

import json

import pytest
import torch

from production_stack_tpu.engine import tools as jax_tools
from production_stack_tpu_torch.engine import tools

from test_torch_n_sampling import ServerPair, events

torch.set_num_threads(1)

WEATHER_TOOL = {
    "type": "function",
    "function": {
        "name": "get_weather",
        "description": "Current weather for a city",
        "parameters": {
            "type": "object",
            "properties": {"city": {"type": "string"}},
            "required": ["city"],
        },
    },
}
CALL = ('<tool_call>{"name": "get_weather", "arguments": '
        '{"city": "Oslo"}}</tool_call>')
CALL_RX = (r'<tool_call>\{"name": "get_weather", "arguments": '
           r'\{"city": "Oslo"\}\}</tool_call>')


def _no_ids(calls):
    """Tool calls without their random ``call_`` ids."""
    return [dict(c, id=c["id"][:5]) for c in calls]


@pytest.mark.parametrize("tool_choice", [
    "auto", "required", "none",
    {"type": "function", "function": {"name": "get_weather"}}])
def test_preamble_copy_equals_jax(tool_choice):
    assert (tools.render_tools_preamble([WEATHER_TOOL], tool_choice)
            == jax_tools.render_tools_preamble([WEATHER_TOOL], tool_choice))
    assert tools.render_tools_preamble([]) == ""
    assert tools.tool_names([WEATHER_TOOL]) == jax_tools.tool_names(
        [WEATHER_TOOL])


@pytest.mark.parametrize("text,allowed", [
    ('Sure, let me check.\n' + CALL, None),
    ('<tool_call>{"name": "a", "arguments": {}}</tool_call>'
     "<tool_call>not json</tool_call>"
     '<tool_call>{"name": "b", "arguments": {"x": 1}}</tool_call>', None),
    ('{"name": "get_weather", "arguments": {"city": "Oslo"}} trailing',
     None),
    ('{"name": "f", "arguments": {"s": "a { b } \\" c"}}', None),
    ("just a normal answer", None), ('{"foo": 1}', None),
    ('{"name": "Alice", "age": 30}', ["get_weather"]),
    ('{"name": "get_weather", "arguments": {"city": "Oslo"}}',
     ["get_weather"]),
    ("before <tool_call>{bad json,}</tool_call> after", None)])
def test_parse_copy_equals_jax(text, allowed):
    content, calls = tools.parse_tool_calls(text, allowed)
    jcontent, jcalls = jax_tools.parse_tool_calls(text, allowed)
    assert content == jcontent
    assert _no_ids(calls) == _no_ids(jcalls)
    assert all(c["id"].startswith("call_") for c in calls)


@pytest.fixture(scope="module")
def pair():
    # Room for the preamble: 382 prompt tokens.
    p = ServerPair(max_model_len=512, num_blocks=128)
    yield p
    p.stop()


def _chat(**over):
    return dict({"messages": [{"role": "user",
                               "content": "weather in Paris?"}],
                 "tools": [WEATHER_TOOL], "max_tokens": 8,
                 "temperature": 0}, **over)


def _message(out):
    msg = dict(out["choices"][0]["message"])
    if "tool_calls" in msg:
        msg["tool_calls"] = _no_ids(msg["tool_calls"])
    return msg, out["choices"][0]["finish_reason"], out["usage"]


@pytest.mark.parametrize("over", [
    {}, {"tool_choice": "none"}, {"tool_choice": "required"},
    {"tool_choice": {"type": "function",
                     "function": {"name": "get_weather"}}},
    {"guided_regex": CALL_RX, "max_tokens": 96},
    {"guided_regex": "Hello " + CALL_RX, "max_tokens": 96,
     "tool_choice": "none"}])
def test_chat_with_tools_equals_the_jax_server(pair, over):
    got, want = pair.post("/v1/chat/completions", _chat(**over))
    assert _message(got) == _message(want)
    msg, finish, usage = _message(got)
    if over.get("tool_choice") == "none":
        plain, _ = pair.post("/v1/chat/completions", {
            "messages": _chat()["messages"], "max_tokens": 1})
        assert usage["prompt_tokens"] == plain["usage"]["prompt_tokens"]
    else:
        assert usage["prompt_tokens"] > 200  # the preamble
    if "guided_regex" in over and over.get("tool_choice") != "none":
        assert finish == "tool_calls" and msg["content"] is None
        assert msg["tool_calls"][0]["function"] == {
            "name": "get_weather", "arguments": json.dumps({"city": "Oslo"})}
    else:
        assert finish in ("stop", "length") and isinstance(
            msg["content"], str)


@pytest.mark.parametrize("over", [
    {}, {"guided_regex": CALL_RX, "max_tokens": 96}])
def test_streamed_chat_with_tools_is_buffered_like_jax(pair, over):
    got, want = pair.post("/v1/chat/completions",
                          _chat(stream=True, **over), raw=True)
    got, want = events(got), events(want)

    def deltas(evs):
        out = []
        for e in evs:
            c = dict(e["choices"][0])
            d = dict(c["delta"])
            if "tool_calls" in d:
                d["tool_calls"] = _no_ids(d["tool_calls"])
            out.append((d, c["finish_reason"]))
        return out

    assert deltas(got) == deltas(want)
    # One buffered delta, then the finish chunk.
    assert len(got) == 2 and got[0]["choices"][0]["delta"]["role"] == (
        "assistant")
    if over:
        assert got[-1]["choices"][0]["finish_reason"] == "tool_calls"
