"""Tokenizers for the engine.

Two implementations behind one interface:

- :class:`HFTokenizer` — wraps a local HuggingFace tokenizer directory
  (transformers is available in-image; downloads are not, so only local
  paths work).
- :class:`ByteTokenizer` — dependency-free byte-level tokenizer (UTF-8
  bytes + specials). Default for preset models with no local checkpoint:
  random-weight models don't produce meaningful text anyway, and byte
  round-tripping keeps streaming/detokenize tests exact.
"""

from __future__ import annotations

from typing import List, Optional


class ByteTokenizer:
    """UTF-8 byte tokenizer. ids 0..255 = bytes; 256=BOS, 257=EOS, 258=PAD."""

    bos_token_id = 256
    eos_token_id = 257
    pad_token_id = 258

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = max(vocab_size, 259)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_token_id] + ids) if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        # ids >= 259 (possible with vocab_size > 259, e.g. random-weight
        # preset models) decode to a deterministic printable char so
        # generated streams are visible; specials (BOS/EOS/PAD) decode to "".
        data = bytes(
            32 + (i - 259) % 95 if i >= 259 else i
            for i in ids
            if 0 <= i < 256 or i >= 259
        )
        return data.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: List[dict]) -> str:
        parts = []
        for m in messages:
            content = m.get("content")
            if isinstance(content, list):
                content = " ".join(
                    seg.get("text", "") for seg in content if isinstance(seg, dict)
                )
            parts.append(f"<|{m.get('role', 'user')}|>\n{content or ''}")
        parts.append("<|assistant|>\n")
        return "\n".join(parts)

    def encode_with_offsets(self, text: str,
                            add_bos: bool = True):
        """(ids, per-token char offsets) in one pass — the admission
        path uses this so the KV controller mapping never re-tokenizes
        the prompt."""
        ids = self.encode(text, add_bos=add_bos)
        return ids, self.token_char_offsets(text, ids)

    def token_char_offsets(self, text: str, ids: List[int]) -> List[int]:
        """Char offset in ``text`` where each token of ``ids`` begins
        (specials take the current position). Exact: one token per UTF-8
        byte, so map byte index -> char index."""
        char_at_byte: List[int] = []
        for j, ch in enumerate(text):
            char_at_byte.extend([j] * len(ch.encode("utf-8")))
        starts: List[int] = []
        byte_i = 0
        for tid in ids:
            if 0 <= tid < 256:
                starts.append(char_at_byte[byte_i]
                              if byte_i < len(char_at_byte) else len(text))
                byte_i += 1
            else:  # BOS/EOS/specials occupy no text
                starts.append(char_at_byte[byte_i]
                              if byte_i < len(char_at_byte) else len(text))
        return starts


class HFTokenizer:
    def __init__(self, path: str, chat_template: Optional[str] = None):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        if chat_template:
            # Custom jinja template (helm modelSpec.chatTemplate — the
            # reference mounts these as configmaps and passes vLLM
            # --chat-template).
            self.tok.chat_template = chat_template
        self.vocab_size = self.tok.vocab_size
        self.bos_token_id = self.tok.bos_token_id
        self.eos_token_id = self.tok.eos_token_id
        self.pad_token_id = self.tok.pad_token_id or self.tok.eos_token_id

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        return self.tok.encode(text, add_special_tokens=add_bos)

    def decode(self, ids: List[int]) -> str:
        return self.tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: List[dict]) -> str:
        try:
            return self.tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True
            )
        except Exception:  # noqa: BLE001 - no template in tokenizer config
            return ByteTokenizer.apply_chat_template(self, messages)  # type: ignore[arg-type]

    def encode_with_offsets(self, text: str, add_bos: bool = True):
        """(ids, per-token char offsets) in ONE tokenizer pass (fast
        tokenizers); (ids, None) when offsets are unavailable. The
        request path uses this when admission reporting is on, so
        _track_admission never re-tokenizes multi-thousand-token
        prompts."""
        try:
            enc = self.tok(text, return_offsets_mapping=True,
                           add_special_tokens=add_bos)
            return (list(enc["input_ids"]),
                    [int(s) for s, _ in enc["offset_mapping"]])
        except Exception:  # noqa: BLE001 - slow tokenizer: no offsets
            return self.encode(text, add_bos=add_bos), None

    def token_char_offsets(self, text: str, ids: List[int]) -> List[int]:
        """Char offset in ``text`` where each token of ``ids`` begins.
        Exact via the fast tokenizer's offset mapping when the re-encode
        reproduces ``ids``; proportional fallback otherwise (slow
        tokenizers, or ids produced from different text). Prefer
        :meth:`encode_with_offsets` on the request path (single pass)."""
        try:
            enc = self.tok(text, return_offsets_mapping=True,
                           add_special_tokens=True)
            if list(enc["input_ids"]) == list(ids):
                return [int(s) for s, _ in enc["offset_mapping"]]
            enc = self.tok(text, return_offsets_mapping=True,
                           add_special_tokens=False)
            if list(enc["input_ids"]) == list(ids):
                return [int(s) for s, _ in enc["offset_mapping"]]
        except Exception:  # noqa: BLE001 - slow tokenizer: no offsets
            pass
        n = max(len(ids), 1)
        ratio = len(text) / n
        return [int(i * ratio) for i in range(len(ids))]


def build_tokenizer(model: str, vocab_size: int,
                    tokenizer_path: Optional[str] = None,
                    chat_template_path: Optional[str] = None):
    import os

    template = None
    if chat_template_path:
        # An explicitly configured template that cannot be read must fail
        # LOUDLY (crashlooping pod), not silently serve the checkpoint's
        # default formatting.
        with open(chat_template_path) as f:
            template = f.read()
    path = tokenizer_path or model
    if os.path.isdir(path):
        try:
            return HFTokenizer(path, chat_template=template)
        except Exception:  # noqa: BLE001
            pass
    return ByteTokenizer(vocab_size)


class IncrementalDetokenizer:
    """Streams text from token ids, holding back bytes that may be a partial
    UTF-8 sequence (byte tokenizer) or partial word (HF).

    Decodes only a sliding window of recent ids (prefix_offset..end), not the
    whole accumulated list, so a T-token stream costs O(T) decodes of bounded
    length instead of O(T^2)."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.ids: List[int] = []
        # ids[prefix_offset:read_offset] decode to text already emitted; the
        # prefix window gives the tokenizer context (spacing, merges) for the
        # unemitted tail.
        self.prefix_offset = 0
        self.read_offset = 0

    def push(self, token_id: int) -> str:
        self.ids.append(token_id)
        prefix_text = self.tokenizer.decode(
            self.ids[self.prefix_offset:self.read_offset]
        )
        new_text = self.tokenizer.decode(self.ids[self.prefix_offset:])
        if len(new_text) > len(prefix_text) and not new_text.endswith("�"):
            delta = new_text[len(prefix_text):]
            self.prefix_offset = self.read_offset
            self.read_offset = len(self.ids)
            return delta
        # Partial sequence (or nothing new): hold back.
        return ""

    def flush(self) -> str:
        prefix_text = self.tokenizer.decode(
            self.ids[self.prefix_offset:self.read_offset]
        )
        new_text = self.tokenizer.decode(self.ids[self.prefix_offset:])
        delta = new_text[len(prefix_text):]
        self.prefix_offset = self.read_offset = len(self.ids)
        return delta
