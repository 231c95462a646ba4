"""Deployment API-key auth of the engine server.

The port's own copy of the JAX-free parts of
``production_stack_tpu/utils/auth.py`` (the port imports nothing of the
JAX package): key resolution, the gated and privileged path sets, and the
constant-time bearer check. The server's 401 body is written by the
server itself (the reference's ``aiohttp`` response helper has no place
in the standard-library server).

Semantics follow vLLM: the key gates the inference surface (``/v1/*``
and its non-versioned aliases) and the privileged control-plane paths
(the whole ``/debug`` tree the engine serves, ``/kv/deregister``);
probes (``/health``, ``/healthz``), scrapes (``/metrics``) and
``/version`` stay open. The engine server gates every ``/kv/*`` route on
top (raw cache pages must not leave without the key). Comparisons are
constant-time (``hmac.compare_digest``)."""

from __future__ import annotations

import hmac
import os
from typing import Iterable, Optional, Tuple, Union

# Non-/v1 aliases of gated inference endpoints.
_GATED_EXACT = frozenset({"/score", "/rerank", "/tokenize", "/detokenize"})


def is_gated(path: str) -> bool:
    """True when the path belongs to the API-key-protected surface."""
    return path.startswith("/v1/") or path in _GATED_EXACT


# Privileged control-plane paths, as the reference lists them (router and
# engine share the set): they can take replicas out of service, steal
# device time (a profiler capture) or leak request ids, workload shape and
# cache topology (every /debug surface).
_PRIVILEGED_EXACT = frozenset({"/kv/deregister", "/debug/profile",
                               "/debug/events", "/debug/traces",
                               "/debug/steps", "/debug/loop",
                               "/debug/lora"})
_PRIVILEGED_PREFIXES = ("/autoscale/", "/debug/profile/",
                        "/debug/traces/", "/debug/kv/",
                        "/debug/snapshot", "/debug/workers",
                        "/lora/")


def is_privileged(path: str) -> bool:
    """True for control-plane paths gated like the inference surface."""
    return (path in _PRIVILEGED_EXACT
            or path.startswith(_PRIVILEGED_PREFIXES))


def _split_keys(value: str) -> Tuple[str, ...]:
    return tuple(k.strip() for k in value.split(",") if k.strip())


def resolve_api_keys(explicit: Optional[str] = None) -> Tuple[str, ...]:
    """All accepted deployment keys, in declaration order.

    Sources, first match wins: the explicit flag value, ``VLLM_API_KEY``
    or ``TPU_STACK_API_KEY``, or a keyfile (``VLLM_API_KEY_FILE`` /
    ``TPU_STACK_API_KEY_FILE``, one key per line, ``#`` comments). Flag
    and environment values may hold several comma-separated keys.

    A configured keyfile that cannot be read raises: returning no keys
    would switch the gate off (fail open)."""
    raw = (explicit or os.environ.get("VLLM_API_KEY")
           or os.environ.get("TPU_STACK_API_KEY") or None)
    if raw:
        return _split_keys(raw)
    keyfile = (os.environ.get("VLLM_API_KEY_FILE")
               or os.environ.get("TPU_STACK_API_KEY_FILE") or None)
    if keyfile:
        try:
            with open(keyfile, encoding="utf-8") as f:
                lines = [ln.strip() for ln in f]
        except OSError as e:
            raise RuntimeError(
                f"API keyfile {keyfile!r} is configured but unreadable "
                f"({e}); refusing to start with auth disabled") from e
        return tuple(ln for ln in lines if ln and not ln.startswith("#"))
    return ()


def check_bearer(authorization: Optional[str],
                 key: Union[str, Iterable[str]]) -> bool:
    """Constant-time check of an ``Authorization: Bearer <key>`` header
    against one key or several; every candidate is compared (no early
    exit), so timing does not tell which key a probe collided with."""
    if not authorization or not authorization.startswith("Bearer "):
        return False
    presented = authorization[len("Bearer "):]
    keys = (key,) if isinstance(key, str) else tuple(key)
    ok = False
    for k in keys:
        ok |= hmac.compare_digest(presented, k)
    return ok


def auth_headers(key: Optional[str]) -> dict:
    """The header that carries ``key`` on a call this process makes."""
    return {"Authorization": f"Bearer {key}"} if key else {}
