"""Token-level FSM over a tokenizer vocabulary, with packed mask rows.

``CharDFA`` (regex_dfa) speaks bytes; the serving engine speaks token
ids. :class:`TokenFSM` bridges them: a token is *allowed* from a DFA
state when walking its UTF-8 bytes keeps the automaton alive, and EOS is
allowed exactly when the state is accepting. Per-state allowed-token
sets are classified lazily — only states a live request actually visits
are materialized — and memoized as ``uint8``-packed bitmask rows
(``numpy.packbits`` little-endian layout) sized to the padded model
vocab, ready to ship to the device as the fused programs' dense mask
input. A schema visits tens of states out of thousands, so lazy beats
eager by orders of magnitude on compile latency.

:class:`StructuredCache` is the engine-side LRU keyed by
``(kind, spec-hash, tokenizer-key)`` with the
``--structured-cache-size`` knob, accumulating the
``tpu:structured_{compile_seconds,mask_states}_total`` counters.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from production_stack_tpu_torch.structured.regex_dfa import CharDFA


def mask_row_bytes(vocab_size: int) -> int:
    """Packed mask row width in bytes for a padded vocab."""
    return (int(vocab_size) + 7) // 8


def token_byte_table(tokenizer, vocab_size: int) -> List[Optional[bytes]]:
    """Per-token UTF-8 byte strings; ``None`` marks ids the automaton
    never admits (BOS/PAD/other specials, or ids that don't decode to
    stable text). Byte-level tokenizers map ids 0..255 to raw bytes
    directly — decoding a lone continuation byte would lose them."""
    specials = {getattr(tokenizer, name, None)
                for name in ("bos_token_id", "pad_token_id", "eos_token_id")}
    byte_level = (getattr(tokenizer, "bos_token_id", None) == 256
                  and getattr(tokenizer, "eos_token_id", None) == 257
                  and not hasattr(tokenizer, "tok"))
    table: List[Optional[bytes]] = []
    for tid in range(vocab_size):
        if tid in specials:
            table.append(None)
            continue
        if byte_level:
            if tid < 256:
                table.append(bytes([tid]))
            elif tid >= 259:
                table.append(bytes([32 + (tid - 259) % 95]))
            else:
                table.append(None)
            continue
        try:
            text = tokenizer.decode([tid])
        except Exception:  # noqa: BLE001 - holes in the vocab
            table.append(None)
            continue
        if not text or "�" in text:
            table.append(None)
            continue
        table.append(text.encode("utf-8"))
    return table


class TokenFSM:
    """Immutable once built; per-request position is just a state int,
    so concurrent requests (and ``n>1`` fan-out) share one instance."""

    def __init__(self, dfa: CharDFA, token_bytes: List[Optional[bytes]],
                 eos_id: Optional[int], vocab_size: int):
        self.dfa = dfa
        self.token_bytes = token_bytes
        self.eos_id = eos_id
        self.vocab_size = int(vocab_size)
        self.row_bytes = mask_row_bytes(vocab_size)
        self._rows: Dict[int, np.ndarray] = {}
        self._lock = threading.Lock()
        self.states_materialized = 0
        # Cache-global counter hook (set by StructuredCache).
        self._on_materialize = None

    @property
    def start(self) -> int:
        return 0

    def advance(self, state: int, token_id: int) -> int:
        """Next DFA state after emitting ``token_id``; -1 = left the
        language (a violation — the mask should make this unreachable)."""
        if state < 0 or token_id >= len(self.token_bytes):
            return -1
        data = self.token_bytes[token_id]
        if data is None:
            return -1
        return self.dfa.walk(state, data)

    def is_accepting(self, state: int) -> bool:
        return state >= 0 and self.dfa.accepting[state]

    def is_complete(self, state: int) -> bool:
        """Accepting with no live continuation: only EOS remains."""
        return self.is_accepting(state) and not self.dfa.has_live_out(state)

    def mask_row(self, state: int) -> np.ndarray:
        """Packed ``uint8[row_bytes]`` allowed-token bitmask for
        ``state`` (bit v of the row = token v allowed; little bitorder,
        matching the device-side ``(row[v // 8] >> (v % 8)) & 1``)."""
        with self._lock:
            row = self._rows.get(state)
            if row is not None:
                return row
        bits = np.zeros((self.row_bytes * 8,), np.uint8)
        if state >= 0:
            # Group tokens by DFA column of their first byte? Walking is
            # already cheap (vocab × avg token bytes); keep it simple.
            for tid, data in enumerate(self.token_bytes):
                if data is None:
                    continue
                if self.dfa.walk(state, data) >= 0:
                    bits[tid] = 1
            if self.eos_id is not None and self.is_accepting(state):
                bits[self.eos_id] = 1
        row = np.packbits(bits, bitorder="little")
        with self._lock:
            if state not in self._rows:
                self._rows[state] = row
                self.states_materialized += 1
                if self._on_materialize is not None:
                    self._on_materialize()
            return self._rows[state]


class FSMState:
    """Per-request FSM cursor: the shared immutable :class:`TokenFSM`
    plus this request's DFA position. ``dead`` latches when an emitted
    token ever leaves the language (mask off; violation counted once)."""

    __slots__ = ("fsm", "state", "dead")

    def __init__(self, fsm: TokenFSM):
        self.fsm = fsm
        self.state = fsm.start
        self.dead = False

    @property
    def masking(self) -> bool:
        return not self.dead

    def mask_row(self) -> np.ndarray:
        return self.fsm.mask_row(self.state)

    def advance(self, token_id: int) -> bool:
        """Consume one emitted token; returns False exactly once, when
        the token leaves the language (the caller counts a violation)."""
        if self.dead:
            return True
        if self.fsm.eos_id is not None and token_id == self.fsm.eos_id:
            if self.fsm.is_accepting(self.state):
                return True
            self.dead = True
            return False
        nxt = self.fsm.advance(self.state, token_id)
        if nxt < 0:
            self.dead = True
            return False
        self.state = nxt
        return True

    @property
    def accepting(self) -> bool:
        return not self.dead and self.fsm.is_accepting(self.state)


def spec_key(kind: str, spec: str) -> str:
    return hashlib.sha256(
        (kind + "\x00" + spec).encode("utf-8")).hexdigest()[:32]


class StructuredCache:
    """LRU of compiled :class:`TokenFSM`s keyed by
    ``(kind, spec-hash, tokenizer-key)``. One entry per distinct schema
    per tokenizer; re-used across requests and across ``n>1`` fan-out."""

    def __init__(self, max_entries: int = 32):
        self.max_entries = max(int(max_entries), 1)
        self._entries: "OrderedDict[Tuple[str, str], TokenFSM]" = \
            OrderedDict()
        self._lock = threading.Lock()
        self._token_table: Optional[List[Optional[bytes]]] = None
        # tpu:structured_* counters (read by EngineCore.stats()).
        self.compile_seconds_total = 0.0
        self.mask_states_total = 0
        self.evictions_total = 0

    def _bump_states(self) -> None:
        with self._lock:
            self.mask_states_total += 1

    def get(self, kind: str, spec: str, tokenizer, tokenizer_key: str,
            vocab_size: int, eos_id: Optional[int],
            compile_fn) -> TokenFSM:
        key = (spec_key(kind, spec), tokenizer_key)
        with self._lock:
            fsm = self._entries.get(key)
            if fsm is not None:
                self._entries.move_to_end(key)
                return fsm
        t0 = time.perf_counter()
        dfa = compile_fn()  # CharDFA (may raise StructuredError -> caller)
        if self._token_table is None:
            # Built once per engine: the vocab doesn't change.
            self._token_table = token_byte_table(tokenizer, vocab_size)
        fsm = TokenFSM(dfa, self._token_table, eos_id, vocab_size)
        fsm._on_materialize = self._bump_states
        dt = time.perf_counter() - t0
        with self._lock:
            self.compile_seconds_total += dt
            if key not in self._entries:
                self._entries[key] = fsm
                while len(self._entries) > self.max_entries:
                    self._entries.popitem(last=False)
                    self.evictions_total += 1
            return self._entries[key]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
