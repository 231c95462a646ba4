"""Regex -> NFA -> DFA compiler over the UTF-8 byte alphabet.

The structured-output subsystem constrains generation with a token-level
FSM (see ``tokenfsm.py``). Its character-level core is this module: a
deliberately small regex dialect compiled to a DFA whose alphabet is raw
bytes 0..255, so the same automaton drives byte-level tokenizers directly
and BPE vocabularies by walking each token's UTF-8 bytes.

Dialect (fullmatch semantics — the whole completion must match):

- literals (non-ASCII chars expand to their UTF-8 byte sequence)
- ``.`` (any byte except newline), ``\\d \\D \\w \\W \\s \\S``
- escapes ``\\n \\t \\r \\f \\v \\0 \\xHH \\uXXXX`` and escaped metachars
- classes ``[a-z0-9_]`` / ``[^...]`` (ASCII members only)
- quantifiers ``* + ? {m} {m,} {m,n}`` (lazy variants accepted; laziness
  is meaningless for a DFA language check)
- groups ``(...)`` / ``(?:...)`` and alternation ``|``

Unsupported constructs (backreferences, lookaround, inline flags) raise
:class:`StructuredError` — the API layer turns that into a 400 rather
than silently serving an unconstrained stream.

Subset construction runs over byte *equivalence classes* (bytes with
identical NFA edge membership collapse to one column), which keeps the
DFA transition table narrow: a JSON-schema automaton typically has a
dozen classes, not 256 columns.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Tuple

# Bounds: a runaway pattern must fail compilation (-> 400) instead of
# stalling the serving thread that compiles it.
MAX_DFA_STATES = 8192
MAX_NFA_STATES = 65536
MAX_REPEAT = 256


class StructuredError(ValueError):
    """Uncompilable or unsupported structured-output spec (maps to 400)."""


_DIGITS = frozenset(range(0x30, 0x3A))
_WORD = frozenset(range(0x30, 0x3A)) | frozenset(range(0x41, 0x5B)) \
    | frozenset(range(0x61, 0x7B)) | frozenset({0x5F})
_SPACE = frozenset({0x20, 0x09, 0x0A, 0x0D, 0x0C, 0x0B})
_ALL = frozenset(range(256))
_DOT = _ALL - {0x0A}


def _escape_set(ch: str) -> Optional[FrozenSet[int]]:
    return {
        "d": _DIGITS, "D": _ALL - _DIGITS,
        "w": _WORD, "W": _ALL - _WORD,
        "s": _SPACE, "S": _ALL - _SPACE,
    }.get(ch)


_ESCAPE_BYTE = {"n": 0x0A, "t": 0x09, "r": 0x0D, "f": 0x0C,
                "v": 0x0B, "0": 0x00, "a": 0x07, "b": 0x08}


# --- AST -------------------------------------------------------------------
# Nodes are plain tuples: ("lit", frozenset[int]) | ("seq", [nodes]) |
# ("alt", [nodes]) | ("rep", node, min, max|None) | ("eps",)


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.atoms = 0  # expansion budget guard

    def error(self, msg: str) -> StructuredError:
        return StructuredError(
            f"regex error at position {self.i}: {msg} in {self.p!r}")

    def peek(self) -> str:
        return self.p[self.i] if self.i < len(self.p) else ""

    def parse(self):
        node = self._alt()
        if self.i < len(self.p):
            raise self.error(f"unexpected {self.p[self.i]!r}")
        return node

    def _alt(self):
        branches = [self._seq()]
        while self.peek() == "|":
            self.i += 1
            branches.append(self._seq())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _seq(self):
        items = []
        while True:
            ch = self.peek()
            if ch in ("", "|", ")"):
                break
            items.append(self._quantified())
        if not items:
            return ("eps",)
        return items[0] if len(items) == 1 else ("seq", items)

    def _quantified(self):
        atom = self._atom()
        ch = self.peek()
        lo: int
        hi: Optional[int]
        if ch == "*":
            self.i += 1
            lo, hi = 0, None
        elif ch == "+":
            self.i += 1
            lo, hi = 1, None
        elif ch == "?":
            self.i += 1
            lo, hi = 0, 1
        elif ch == "{":
            save = self.i
            parsed = self._brace()
            if parsed is None:
                self.i = save
                return atom
            lo, hi = parsed
        else:
            return atom
        if self.peek() == "?":  # lazy quantifier: same language for a DFA
            self.i += 1
        if hi is not None and (hi > MAX_REPEAT or lo > hi):
            raise self.error(f"repetition bound over {MAX_REPEAT}")
        if lo > MAX_REPEAT:
            raise self.error(f"repetition bound over {MAX_REPEAT}")
        return ("rep", atom, lo, hi)

    def _brace(self) -> Optional[Tuple[int, Optional[int]]]:
        # "{m}" / "{m,}" / "{m,n}"; a non-quantifier "{" is a literal.
        j = self.p.find("}", self.i)
        if j < 0:
            return None
        body = self.p[self.i + 1:j]
        parts = body.split(",")
        try:
            if len(parts) == 1:
                lo = int(parts[0])
                hi: Optional[int] = lo
            elif len(parts) == 2:
                lo = int(parts[0]) if parts[0] else 0
                hi = int(parts[1]) if parts[1] else None
            else:
                return None
        except ValueError:
            return None
        self.i = j + 1
        return lo, hi

    def _atom(self):
        self.atoms += 1
        if self.atoms > 20000:
            raise self.error("pattern too large")
        ch = self.peek()
        if ch == "(":
            self.i += 1
            if self.p.startswith("?:", self.i):
                self.i += 2
            elif self.peek() == "?":
                raise self.error("lookaround/inline groups unsupported")
            node = self._alt()
            if self.peek() != ")":
                raise self.error("unterminated group")
            self.i += 1
            return node
        if ch == "[":
            return ("lit", self._cls())
        if ch == ".":
            self.i += 1
            return ("lit", _DOT)
        if ch == "\\":
            return self._escape()
        if ch in ("^", "$"):
            # fullmatch semantics make edge anchors no-ops; mid-pattern
            # anchors would change the language silently -> reject.
            if (ch == "^" and self.i == 0) or \
                    (ch == "$" and self.i == len(self.p) - 1):
                self.i += 1
                return ("eps",)
            raise self.error("mid-pattern anchors unsupported")
        if ch in ")*+?":
            raise self.error(f"dangling {ch!r}")
        self.i += 1
        return self._literal_char(ch)

    def _literal_char(self, ch: str):
        data = ch.encode("utf-8")
        if len(data) == 1:
            return ("lit", frozenset({data[0]}))
        return ("seq", [("lit", frozenset({b})) for b in data])

    def _escape(self):
        self.i += 1  # consume "\\"
        ch = self.peek()
        if not ch:
            raise self.error("trailing backslash")
        self.i += 1
        fs = _escape_set(ch)
        if fs is not None:
            return ("lit", fs)
        if ch in _ESCAPE_BYTE and ch != "b":
            return ("lit", frozenset({_ESCAPE_BYTE[ch]}))
        if ch == "b":
            raise self.error("word-boundary \\b unsupported")
        if ch == "x":
            hx = self.p[self.i:self.i + 2]
            if len(hx) != 2:
                raise self.error("bad \\x escape")
            self.i += 2
            return ("lit", frozenset({int(hx, 16)}))
        if ch == "u":
            hx = self.p[self.i:self.i + 4]
            if len(hx) != 4:
                raise self.error("bad \\u escape")
            self.i += 4
            return self._literal_char(chr(int(hx, 16)))
        if ch.isdigit():
            raise self.error("backreferences unsupported")
        return self._literal_char(ch)

    def _cls(self) -> FrozenSet[int]:
        # "[...]" with ASCII members; non-ASCII literals can't live in a
        # byte set (they're multi-byte sequences) -> reject loudly.
        self.i += 1  # "["
        negate = False
        if self.peek() == "^":
            negate = True
            self.i += 1
        members: set = set()
        first = True
        while True:
            ch = self.peek()
            if not ch:
                raise self.error("unterminated class")
            if ch == "]" and not first:
                self.i += 1
                break
            first = False
            lo = self._cls_one()
            if isinstance(lo, frozenset):
                members |= lo
                continue
            if self.peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self.i += 1
                hi = self._cls_one()
                if isinstance(hi, frozenset) or hi < lo:
                    raise self.error("bad class range")
                members |= set(range(lo, hi + 1))
            else:
                members.add(lo)
        return frozenset(_ALL - members) if negate else frozenset(members)

    def _cls_one(self):
        ch = self.peek()
        if ch == "\\":
            self.i += 1
            ch = self.peek()
            self.i += 1
            fs = _escape_set(ch)
            if fs is not None:
                return fs
            if ch in _ESCAPE_BYTE:
                return _ESCAPE_BYTE[ch]
            if ch == "x":
                hx = self.p[self.i:self.i + 2]
                if len(hx) != 2:
                    raise self.error("bad \\x escape")
                self.i += 2
                return int(hx, 16)
            if len(ch.encode("utf-8")) != 1:
                raise self.error("non-ASCII class member")
            return ord(ch)
        self.i += 1
        if len(ch.encode("utf-8")) != 1:
            raise self.error("non-ASCII class member")
        return ord(ch)


# --- NFA -------------------------------------------------------------------


class _NFA:
    def __init__(self):
        self.n = 0
        self.eps: List[List[int]] = []
        # Per-state byte edges: list of (charset_id, dst).
        self.edges: List[List[Tuple[int, int]]] = []
        self.charsets: List[FrozenSet[int]] = []
        self._cs_ids: Dict[FrozenSet[int], int] = {}

    def state(self) -> int:
        if self.n >= MAX_NFA_STATES:
            raise StructuredError("pattern too large (NFA state cap)")
        self.eps.append([])
        self.edges.append([])
        self.n += 1
        return self.n - 1

    def charset(self, fs: FrozenSet[int]) -> int:
        got = self._cs_ids.get(fs)
        if got is None:
            got = self._cs_ids[fs] = len(self.charsets)
            self.charsets.append(fs)
        return got

    def build(self, node) -> Tuple[int, int]:
        """Thompson construction: returns (entry, exit) states."""
        kind = node[0]
        if kind == "eps":
            s = self.state()
            return s, s
        if kind == "lit":
            fs = node[1]
            if not fs:
                raise StructuredError("empty character class matches nothing")
            a, b = self.state(), self.state()
            self.edges[a].append((self.charset(fs), b))
            return a, b
        if kind == "seq":
            first_in, prev_out = self.build(node[1][0])
            for child in node[1][1:]:
                cin, cout = self.build(child)
                self.eps[prev_out].append(cin)
                prev_out = cout
            return first_in, prev_out
        if kind == "alt":
            a, b = self.state(), self.state()
            for child in node[1]:
                cin, cout = self.build(child)
                self.eps[a].append(cin)
                self.eps[cout].append(b)
            return a, b
        if kind == "rep":
            _, child, lo, hi = node
            parts: List[Tuple[int, int]] = []
            for _i in range(lo):
                parts.append(self.build(child))
            if hi is None:
                # child* tail
                a, b = self.state(), self.state()
                cin, cout = self.build(child)
                self.eps[a] += [cin, b]
                self.eps[cout] += [cin, b]
                parts.append((a, b))
            else:
                for _i in range(hi - lo):  # optional copies
                    a, b = self.state(), self.state()
                    cin, cout = self.build(child)
                    self.eps[a] += [cin, b]
                    self.eps[cout].append(b)
                    parts.append((a, b))
            if not parts:
                s = self.state()
                return s, s
            for (_pi, pout), (nin, _nout) in zip(parts, parts[1:]):
                self.eps[pout].append(nin)
            return parts[0][0], parts[-1][1]
        raise StructuredError(f"internal: unknown AST node {kind!r}")


# --- DFA -------------------------------------------------------------------


@dataclasses.dataclass
class CharDFA:
    """Byte-alphabet DFA with equivalence-class columns.

    ``class_of[byte]`` maps a byte to its column; ``trans[state][cls]``
    is the next state or ``-1`` (dead). State 0 is the start state.
    """

    class_of: List[int]            # 256 entries
    class_bytes: List[List[int]]   # bytes in each class (sorted)
    trans: List[List[int]]
    accepting: List[bool]
    pattern: str = ""

    @property
    def n_states(self) -> int:
        return len(self.trans)

    def step(self, state: int, byte: int) -> int:
        if state < 0:
            return -1
        return self.trans[state][self.class_of[byte]]

    def walk(self, state: int, data) -> int:
        if isinstance(data, str):
            data = data.encode("utf-8")
        for b in data:
            state = self.step(state, b)
            if state < 0:
                return -1
        return state

    def fullmatch(self, data) -> bool:
        s = self.walk(0, data)
        return s >= 0 and self.accepting[s]

    def has_live_out(self, state: int) -> bool:
        return state >= 0 and any(t >= 0 for t in self.trans[state])

    def example(self, max_len: int = 4096) -> str:
        """Shortest accepting byte string (BFS), preferring printable
        bytes per class — drives the fake engine's structured replies
        and the conformance harness."""
        reps = []
        for members in self.class_bytes:
            printable = [b for b in members if 0x20 <= b < 0x7F]
            reps.append(printable[0] if printable else members[0])
        prev: Dict[int, Tuple[int, int]] = {}  # state -> (from_state, byte)
        frontier = [0]
        seen = {0}
        goal = 0 if self.accepting[0] else -1
        depth = 0
        while goal < 0 and frontier and depth < max_len:
            depth += 1
            nxt = []
            for st in frontier:
                for cls, dst in enumerate(self.trans[st]):
                    if dst < 0 or dst in seen:
                        continue
                    seen.add(dst)
                    prev[dst] = (st, reps[cls])
                    if self.accepting[dst]:
                        goal = dst
                        break
                    nxt.append(dst)
                if goal >= 0:
                    break
            frontier = nxt
        if goal < 0:
            raise StructuredError("automaton has no accepting path")
        out = bytearray()
        st = goal
        while st in prev:  # start state is never a BFS discovery
            st, byte = prev[st]
            out.append(byte)
        out.reverse()
        return bytes(out).decode("utf-8", errors="replace")


def _eps_closure(nfa: _NFA, states: FrozenSet[int],
                 memo: Dict[FrozenSet[int], FrozenSet[int]]) -> FrozenSet[int]:
    got = memo.get(states)
    if got is not None:
        return got
    stack = list(states)
    out = set(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in out:
                out.add(t)
                stack.append(t)
    res = frozenset(out)
    memo[states] = res
    return res


def compile_regex(pattern: str) -> CharDFA:
    """Compile ``pattern`` into a trimmed byte-alphabet :class:`CharDFA`."""
    ast = _Parser(pattern).parse()
    nfa = _NFA()
    start, accept = nfa.build(ast)

    # Alphabet equivalence classes: bytes with identical charset
    # membership share a DFA column.
    sig_of: Dict[Tuple[int, ...], int] = {}
    class_of = [0] * 256
    class_bytes: List[List[int]] = []
    for byte in range(256):
        sig = tuple(i for i, fs in enumerate(nfa.charsets) if byte in fs)
        cls = sig_of.get(sig)
        if cls is None:
            cls = sig_of[sig] = len(class_bytes)
            class_bytes.append([])
        class_of[byte] = cls
        class_bytes[cls].append(byte)
    n_cls = len(class_bytes)

    memo: Dict[FrozenSet[int], FrozenSet[int]] = {}
    start_set = _eps_closure(nfa, frozenset({start}), memo)
    subsets: Dict[FrozenSet[int], int] = {start_set: 0}
    order = [start_set]
    trans: List[List[int]] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        row = [-1] * n_cls
        # Gather this subset's outgoing charset edges once.
        by_cs: Dict[int, set] = {}
        for s in cur:
            for cs_id, dst in nfa.edges[s]:
                by_cs.setdefault(cs_id, set()).add(dst)
        for cls in range(n_cls):
            rep = class_bytes[cls][0]
            move: set = set()
            for cs_id, dsts in by_cs.items():
                if rep in nfa.charsets[cs_id]:
                    move |= dsts
            if not move:
                continue
            closed = _eps_closure(nfa, frozenset(move), memo)
            nxt = subsets.get(closed)
            if nxt is None:
                if len(order) >= MAX_DFA_STATES:
                    raise StructuredError(
                        "pattern too large (DFA state cap)")
                nxt = subsets[closed] = len(order)
                order.append(closed)
            row[cls] = nxt
        trans.append(row)
    accepting = [accept in subset for subset in order]

    # Trim: drop states that cannot reach an accepting state (their mask
    # rows would allow tokens that can only dead-end).
    n = len(trans)
    rev: List[List[int]] = [[] for _ in range(n)]
    for src, row in enumerate(trans):
        for dst in row:
            if dst >= 0:
                rev[dst].append(src)
    live = [False] * n
    stack = [s for s in range(n) if accepting[s]]
    for s in stack:
        live[s] = True
    while stack:
        s = stack.pop()
        for p in rev[s]:
            if not live[p]:
                live[p] = True
                stack.append(p)
    if not live[0]:
        raise StructuredError("pattern matches no string")
    remap = [-1] * n
    k = 0
    for s in range(n):
        if live[s]:
            remap[s] = k
            k += 1
    new_trans = []
    new_acc = []
    for s in range(n):
        if not live[s]:
            continue
        new_trans.append([remap[d] if d >= 0 and live[d] else -1
                          for d in trans[s]])
        new_acc.append(accepting[s])
    return CharDFA(class_of=class_of, class_bytes=class_bytes,
                   trans=new_trans, accepting=new_acc, pattern=pattern)
