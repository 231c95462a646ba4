"""The traffic generator: the same schedule for the same seed, the same
sizes in another order for another seed, every size in its range."""

import json
import os

from portbench import traffic
from portbench.tests.tinybench import REPO

SEED = 2 ** 31 + 12345  # larger than 32 signed bits


def mix(name):
    with open(os.path.join(REPO, "portbench", "traffic",
                           name + ".json")) as f:
        return json.load(f)


def sizes(s):
    return (sorted(r.prompt_len for r in s.requests),
            sorted(r.max_tokens for r in s.requests))


def test_same_seed_same_schedule():
    for name in ("chat-decode", "rag-prefix"):
        a = traffic.build(mix(name), SEED, 32000, 30)
        b = traffic.build(mix(name), SEED, 32000, 30)
        assert [(r.rid, r.segments, r.max_tokens, r.due)
                for r in a.requests] == [(r.rid, r.segments, r.max_tokens,
                                          r.due) for r in b.requests]
        r0 = a.requests[0]
        assert a.prompt_ids(r0) == b.prompt_ids(r0)


def test_other_seed_same_sizes_other_order():
    a = traffic.build(mix("chat-decode"), SEED, 32000, 30)
    b = traffic.build(mix("chat-decode"), SEED + 1, 32000, 30)
    assert sizes(a) == sizes(b)
    assert ([r.prompt_len for r in a.requests]
            != [r.prompt_len for r in b.requests])
    assert a.prompt_ids(a.requests[0]) != b.prompt_ids(b.requests[0])
    ra = traffic.build(mix("rag-prefix"), SEED, 32000, 30)
    rb = traffic.build(mix("rag-prefix"), SEED + 1, 32000, 30)
    # Sessions: the same gaps in another order, so the same count.
    assert (len({r.rid.split("-")[0] for r in ra.requests})
            == len({r.rid.split("-")[0] for r in rb.requests}))


def test_chat_ranges():
    m = mix("chat-decode")
    s = traffic.build(m, SEED, 32000, 30)
    assert s.loop == "closed" and s.clients == m["clients"]
    assert len(s.by_client()) == m["clients"]
    assert all(128 <= r.prompt_len <= 512 for r in s.requests)
    assert all(256 <= r.max_tokens <= 1024 for r in s.requests)
    assert max(s.starts) < m["stagger_s"]
    ids = s.prompt_ids(s.requests[0])
    assert len(ids) == s.requests[0].prompt_len
    assert all(0 <= t < 32000 for t in ids)


def test_rag_ranges_and_sharing():
    m = mix("rag-prefix")
    s = traffic.build(m, SEED, 32000, 30)
    horizon = m["ramp_s"] + 30
    dues = [r.due for r in s.requests]
    assert dues == sorted(dues) and 0 <= dues[0] and dues[-1] < horizon
    sessions = {}
    for r in s.requests:
        doc, q = r.segments
        assert 2048 <= doc[1] <= 3072 and 32 <= q[1] <= 128
        assert 32 <= r.max_tokens <= 128
        assert r.prompt_len + r.max_tokens <= 3328
        sessions.setdefault(doc[0], []).append(r)
    assert all(len(v) <= 5 for v in sessions.values())
    assert any(len(v) >= 3 for v in sessions.values())
    # Asks of one document share its tokens; their questions differ.
    asks = next(v for v in sessions.values() if len(v) >= 2)
    a, b = (s.prompt_ids(r) for r in asks[:2])
    n = asks[0].segments[0][1]
    assert a[:n] == b[:n] and a[n:] != b[n:]
    # Offered rate: the sessions' asks over the horizon, near rate_rps.
    assert 0.6 * m["rate_rps"] <= len(s.requests) / horizon <= m["rate_rps"]


def test_shared_prefix_tokens_by_hand():
    block = 4
    p1 = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    p2 = [1, 2, 3, 4, 5, 6, 7, 0, 9, 9]      # shares one whole block
    p3 = [1, 2, 3, 4, 5, 6, 7, 8, 1, 1, 1, 1]  # shares two
    p4 = [9, 2, 3, 4, 5, 6, 7, 8]             # first block differs
    assert traffic.shared_prefix_tokens([p1, p2, p3, p4], block) == [
        0, 4, 8, 0]


def test_quantiles_cover_the_distribution():
    d = {"dist": "lognormal", "median": 256, "sigma": 0.5, "min": 128,
         "max": 512}
    vals = sorted(traffic.quantile(d, (i + 0.5) / 1001) for i in range(1001))
    assert vals[0] == 128 and vals[-1] == 512
    assert abs(vals[500] - 256) < 1e-6
    e = {"dist": "exponential", "mean": 4.0}
    assert abs(traffic.mean(e) - 4.0) < 1e-12
    assert traffic.mean({"dist": "uniform", "min": 3, "max": 5}) == 4.0
