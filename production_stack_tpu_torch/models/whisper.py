"""Whisper-class speech-to-text model in PyTorch.

The port of ``production_stack_tpu/models/whisper.py``: the same
configuration presets, the same host-side audio path (numpy copies of the
WAV decoder and the log-mel frontend, bit for bit the JAX package's), the
JAX parameter tree's leaf names and layouts (projections ``[in, out]``,
convolutions ``[k, in, out]``, one dict a block, so a JAX tree crosses
over through ``models/convert.py::whisper_params_from_numpy``), and the
same forward:

- encoder: two k=3 convolutions with explicit ``(1, 1)`` padding, the
  second at stride 2, each with a tanh-approximated GELU (``jax.nn.gelu``'s
  default), sinusoidal positions, pre-LN blocks;
- decoder: learned positions, causal self-attention, cross-attention
  over the encoder states, a head tied to the token embedding;
- LayerNorm in float32, cast to the input dtype before the gain and the
  bias; attention as two products with a float32 softmax and a ``-1e30``
  mask (the scores a product in the model dtype, then float32); the
  logits a product in the model dtype, then float32.

Each convolution is computed as three shifted products over ``W[k]``
(plain matrix products: no cuDNN, so a float32 run on the card is not
taken to TF32 by ``torch.backends.cudnn.allow_tf32``).

The decoder's form differs from the JAX one, not its function: JAX
scores the whole ``max_target_len`` buffer with position masking each
step (static shapes for one compiled program) and recomputes ``enc @ xk``
each step. Here the decoder runs over the ``n`` valid tokens only and the
cross-attention K/V are computed once a request (:func:`cross_kv`).
Masked positions never reach the last valid row (their scores are
``-1e30``, whose weights are exactly zero in float32), so the logits of
that row are the JAX function's.

The entry points run on the card unless the caller passes
``device="cpu"``. Weights are drawn from a seed for the named presets, or
loaded from a local HF checkpoint directory
(``models/weights.py::load_whisper_checkpoint``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
CHUNK_SECONDS = 30
N_FRAMES = SAMPLE_RATE * CHUNK_SECONDS // HOP_LENGTH  # 3000
MASK_VALUE = -1e30  # the JAX model's attention mask value


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    name: str = "tiny-whisper"
    vocab_size: int = 512           # ByteTokenizer-compatible default
    d_model: int = 64
    encoder_layers: int = 2
    decoder_layers: int = 2
    num_heads: int = 2
    max_target_len: int = 448
    n_mels: int = N_MELS
    n_audio_ctx: int = N_FRAMES // 2  # after stride-2 conv
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}[self.dtype]


WHISPER_PRESETS = {
    # Test-scale preset: exercises every code path in seconds on CPU.
    "tiny-whisper": WhisperConfig(),
    # openai/whisper-small card dimensions (12+12 layers, d_model 768).
    "whisper-small": WhisperConfig(
        name="whisper-small", vocab_size=51865, d_model=768,
        encoder_layers=12, decoder_layers=12, num_heads=12,
    ),
}


# --------------------------------------------------------------------- #
# Mel frontend (host-side numpy; no librosa/soundfile in the image)
# --------------------------------------------------------------------- #

def _mel_filterbank(n_mels: int = N_MELS, n_fft: int = N_FFT,
                    sr: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-scale triangular mel filterbank, (n_mels, n_fft//2+1) —
    linear below 1 kHz, log above, matching librosa / HF's
    WhisperFeatureExtractor so checkpoint inputs are bit-comparable."""
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3.0)  # 15.0
    logstep = math.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        return np.where(
            f >= min_log_hz,
            min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
            f / (200.0 / 3.0),
        )

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(
            m >= min_log_mel,
            min_log_hz * np.exp(logstep * (m - min_log_mel)),
            m * (200.0 / 3.0),
        )

    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2),
                                    n_mels + 2))
    fb = np.zeros((n_mels, len(fft_freqs)), dtype=np.float32)
    for i in range(n_mels):
        lo, ctr, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-8)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-8)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    # Area-normalize each filter.
    enorm = 2.0 / (mel_pts[2:] - mel_pts[:-2])
    fb *= enorm[:, None]
    return fb


_FILTERBANK: Optional[np.ndarray] = None


def log_mel_spectrogram(audio: np.ndarray) -> np.ndarray:
    """float32 PCM [-1, 1] -> (n_mels, N_FRAMES) log-mel features,
    padded/trimmed to the 30 s window (whisper's audio.py contract)."""
    global _FILTERBANK
    if _FILTERBANK is None:
        _FILTERBANK = _mel_filterbank()
    target = SAMPLE_RATE * CHUNK_SECONDS
    audio = np.asarray(audio, dtype=np.float32)[:target]
    if len(audio) < target:
        audio = np.pad(audio, (0, target - len(audio)))
    # Whisper's STFT contract is center=True: reflect-pad N_FFT//2 per side
    # so exactly N_FRAMES (3000) frames come out; without it the framing
    # yields 2998 and the stride-2 encoder conv misaligns with enc_pos.
    audio = np.pad(audio, (N_FFT // 2, N_FFT // 2), mode="reflect")
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    n_frames = 1 + (len(audio) - N_FFT) // HOP_LENGTH
    idx = (np.arange(N_FFT)[None, :]
           + HOP_LENGTH * np.arange(n_frames)[:, None])
    frames = audio[idx] * window
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2  # (T, n_fft//2+1)
    mel = _FILTERBANK @ spec.T                        # (n_mels, T)
    log_mel = np.log10(np.maximum(mel, 1e-10))
    log_mel = np.maximum(log_mel, log_mel.max() - 8.0)
    log_mel = (log_mel + 4.0) / 4.0
    return log_mel[:, :N_FRAMES].astype(np.float32)


def decode_wav_bytes(data: bytes) -> np.ndarray:
    """WAV bytes -> mono float32 PCM at 16 kHz (stdlib ``wave`` only;
    non-16k inputs are linearly resampled)."""
    import io
    import wave

    with wave.open(io.BytesIO(data)) as w:
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        channels = w.getnchannels()
        rate = w.getframerate()
    if width == 2:
        pcm = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 1:
        pcm = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
               - 128.0) / 128.0
    elif width == 4:
        pcm = (np.frombuffer(raw, dtype="<i4").astype(np.float32)
               / 2147483648.0)
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if channels > 1:
        pcm = pcm.reshape(-1, channels).mean(axis=1)
    if rate != SAMPLE_RATE and len(pcm):
        t_new = np.linspace(0, len(pcm) - 1,
                            int(len(pcm) * SAMPLE_RATE / rate))
        pcm = np.interp(t_new, np.arange(len(pcm)), pcm).astype(np.float32)
    return pcm


# --------------------------------------------------------------------- #
# Model
# --------------------------------------------------------------------- #

def _sinusoids(length: int, channels: int) -> np.ndarray:
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


def init_whisper_params(cfg: WhisperConfig, seed: int = 0,
                        device="cuda") -> Dict:
    """Random-init parameter dict with the shapes and scales of the JAX
    ``init_whisper_params`` (normal x 0.02 for every projection, the
    convolutions and both embeddings, unit LayerNorm gains, zero biases,
    sinusoidal encoder positions, a 4 x d_model FFN), drawn in float32
    from a CPU ``torch.Generator`` seeded with ``seed`` (so one seed gives
    the same weights on any device), cast to ``cfg``'s dtype and moved to
    ``device``. The values differ from the JAX init's."""
    gen = torch.Generator().manual_seed(int(seed))
    dt = cfg.torch_dtype
    d = cfg.d_model

    def dense(*shape):
        return (torch.randn(shape, generator=gen) * 0.02).to(
            dtype=dt, device=device)

    def ones(n):
        return torch.ones((n,), dtype=dt, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    def block():
        # q/v/out projections carry biases, k does not (HF Whisper's
        # parameterization).
        return {
            "ln1_g": ones(d), "ln1_b": zeros(d),
            "q": dense(d, d), "q_b": zeros(d),
            "k": dense(d, d),
            "v": dense(d, d), "v_b": zeros(d),
            "o": dense(d, d), "o_b": zeros(d),
            "ln2_g": ones(d), "ln2_b": zeros(d),
            "fc1": dense(d, 4 * d), "fc1_b": zeros(4 * d),
            "fc2": dense(4 * d, d), "fc2_b": zeros(d),
        }

    def cross():
        return {
            "lnx_g": ones(d), "lnx_b": zeros(d),
            "xq": dense(d, d), "xq_b": zeros(d),
            "xk": dense(d, d),
            "xv": dense(d, d), "xv_b": zeros(d),
            "xo": dense(d, d), "xo_b": zeros(d),
        }

    return {
        "conv1": dense(3, cfg.n_mels, d), "conv1_b": zeros(d),
        "conv2": dense(3, d, d), "conv2_b": zeros(d),
        "enc_pos": torch.from_numpy(_sinusoids(cfg.n_audio_ctx, d)).to(
            dtype=dt, device=device),
        "enc_blocks": [block() for _ in range(cfg.encoder_layers)],
        "enc_ln_g": ones(d), "enc_ln_b": zeros(d),
        "tok_emb": dense(cfg.vocab_size, d),
        "dec_pos": dense(cfg.max_target_len, d),
        "dec_blocks": [{**block(), **cross()}
                       for _ in range(cfg.decoder_layers)],
        "dec_ln_g": ones(d), "dec_ln_b": zeros(d),
    }


def params_to(tree, device):
    """A parameter tree (dicts, block lists, tensors) on ``device``, e.g.
    the CPU tree ``load_whisper_checkpoint`` returns."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to(v, device) for v in tree]
    return tree.to(device)


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
        eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 (population variance), cast to ``x``'s dtype
    BEFORE the gain and bias, as the JAX ``_ln`` orders it."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g + b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _mha(q, k, v, heads: int, mask=None):
    """(Tq,d),(Tk,d),(Tk,d) -> (Tq,d) multi-head attention: the scores a
    product in the inputs' dtype, then float32 over sqrt(head_dim), masked
    with -1e30, a float32 softmax cast back, and the second product."""
    tq, d = q.shape
    tk = k.shape[0]
    hd = d // heads
    qh = q.reshape(tq, heads, hd).transpose(0, 1)
    kh = k.reshape(tk, heads, hd).transpose(0, 1)
    vh = v.reshape(tk, heads, hd).transpose(0, 1)
    scores = torch.matmul(qh, kh.transpose(1, 2)).float()
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = scores.masked_fill(~mask, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(probs, vh)
    return out.transpose(0, 1).reshape(tq, d)


def _mlp(x, blk):
    h = _ln(x, blk["ln2_g"], blk["ln2_b"])
    return x + (_gelu(h @ blk["fc1"] + blk["fc1_b"]) @ blk["fc2"]
                + blk["fc2_b"])


def _self_block(x, blk, heads, mask=None):
    h = _ln(x, blk["ln1_g"], blk["ln1_b"])
    att = _mha(h @ blk["q"] + blk["q_b"], h @ blk["k"],
               h @ blk["v"] + blk["v_b"], heads, mask)
    x = x + att @ blk["o"] + blk["o_b"]
    return _mlp(x, blk)


def _conv3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int) -> torch.Tensor:
    """A k=3 convolution over time with (1, 1) zero padding: ``x`` (T,
    C_in), ``w`` (3, C_in, C_out) (the JAX ``WIO`` layout) -> (T_out,
    C_out), computed as three shifted products over ``w[k]`` summed in
    float32 and rounded once to ``x``'s dtype (as one convolution rounds
    its float32 accumulator)."""
    t = x.shape[0]
    t_out = (t + 2 - 3) // stride + 1
    xp = F.pad(x, (0, 0, 1, 1)).float()
    span = stride * (t_out - 1) + 1
    out = sum(xp[k:k + span:stride] @ w[k].float() for k in range(3))
    return out.to(x.dtype) + b


def encode_audio(params: Dict, cfg: WhisperConfig, mel) -> torch.Tensor:
    """(n_mels, N_FRAMES) log-mel (numpy or a tensor) -> (n_audio_ctx,
    d_model) encoder states on the parameters' device."""
    conv1 = params["conv1"]
    x = torch.as_tensor(mel).to(device=conv1.device).T.to(conv1.dtype)
    x = _gelu(_conv3(x, conv1, params["conv1_b"], 1))
    x = _gelu(_conv3(x, params["conv2"], params["conv2_b"], 2))
    x = x + params["enc_pos"]
    for blk in params["enc_blocks"]:
        x = _self_block(x, blk, cfg.num_heads)
    return _ln(x, params["enc_ln_g"], params["enc_ln_b"])


def cross_kv(params: Dict, enc: torch.Tensor
             ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each decoder block's cross-attention (K, V) over the encoder
    states: computed once a request."""
    return [(enc @ blk["xk"], enc @ blk["xv"] + blk["xv_b"])
            for blk in params["dec_blocks"]]


def decoder_logits(params: Dict, cfg: WhisperConfig, tokens, n_tokens,
                   enc: Optional[torch.Tensor] = None,
                   kv: Optional[Sequence] = None) -> torch.Tensor:
    """The float32 (vocab,) logits at the last valid position of
    ``tokens`` (a buffer whose first ``n_tokens`` entries are valid, the
    JAX signature), over the encoder states ``enc`` or their per-block
    cross K/V ``kv`` from :func:`cross_kv`. Runs the decoder over the
    ``n_tokens`` valid positions only (see the module docstring)."""
    n = int(n_tokens)
    emb = params["tok_emb"]
    dev = emb.device
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.as_tensor(np.asarray(tokens))
    ids = tokens[:n].to(device=dev, dtype=torch.long)
    if kv is None:
        kv = cross_kv(params, enc)
    x = emb[ids] + params["dec_pos"][:n]
    causal = torch.ones((n, n), dtype=torch.bool, device=dev).tril()
    for blk, (xk, xv) in zip(params["dec_blocks"], kv):
        h = _ln(x, blk["ln1_g"], blk["ln1_b"])
        att = _mha(h @ blk["q"] + blk["q_b"], h @ blk["k"],
                   h @ blk["v"] + blk["v_b"], cfg.num_heads, causal[None])
        x = x + att @ blk["o"] + blk["o_b"]
        h = _ln(x, blk["lnx_g"], blk["lnx_b"])
        xatt = _mha(h @ blk["xq"] + blk["xq_b"], xk, xv, cfg.num_heads)
        x = x + xatt @ blk["xo"] + blk["xo_b"]
        x = _mlp(x, blk)
    last = _ln(x[n - 1:n], params["dec_ln_g"], params["dec_ln_b"])[0]
    return (last @ emb.T.to(last.dtype)).float()


class WhisperModel:
    """Greedy transcriber over the functions above.

    ``params`` overrides the seeded init (checkpoint loading lives in
    :func:`production_stack_tpu_torch.models.weights.load_whisper_checkpoint`);
    given, it must already be on ``device``."""

    def __init__(self, cfg: WhisperConfig, seed: int = 0,
                 params: Optional[Dict] = None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = (params if params is not None
                       else init_whisper_params(cfg, seed, self.device))

    @torch.inference_mode()
    def encode(self, mel) -> torch.Tensor:
        return encode_audio(self.params, self.cfg, mel)

    def _mask(self, ids) -> torch.Tensor:
        """The additive (vocab,) float32 mask, -inf at ``ids`` (in range)
        and 0 elsewhere: suppressed before the argmax, so a suppressed
        token is never selected or fed back (HF's
        SuppressTokensLogitsProcessor)."""
        mask = np.zeros((self.cfg.vocab_size,), np.float32)
        for t in ids:
            if 0 <= t < self.cfg.vocab_size:
                mask[t] = -np.inf
        return torch.from_numpy(mask).to(self.device)

    @torch.inference_mode()
    def generate(self, enc: torch.Tensor, prefix: List[int], eot: int,
                 max_tokens: int, suppress: Tuple[int, ...] = (),
                 begin_suppress: Tuple[int, ...] = ()) -> List[int]:
        """Greedy tokens after ``prefix`` over the encoder states ``enc``,
        until ``eot`` (not returned) or ``min(max_tokens, max_target_len
        - len(prefix))`` tokens."""
        kv = cross_kv(self.params, enc)
        buf = list(prefix)
        out: List[int] = []
        mask = self._mask(suppress)
        begin_mask = self._mask(tuple(suppress) + tuple(begin_suppress))
        limit = min(max_tokens, self.cfg.max_target_len - len(buf))
        for i in range(limit):
            logits = decoder_logits(self.params, self.cfg, buf, len(buf),
                                    kv=kv)
            nxt = int(torch.argmax(logits + (begin_mask if i == 0
                                             else mask)))
            if nxt == eot:
                break
            out.append(nxt)
            buf.append(nxt)
        return out

    def transcribe_tokens(self, audio: np.ndarray, sot, eot: int,
                          max_tokens: int = 64,
                          suppress: Tuple[int, ...] = (),
                          begin_suppress: Tuple[int, ...] = ()) -> List[int]:
        """float32 PCM -> generated token ids (greedy, until EOT).

        ``sot`` may be a single id or a forced prefix sequence (HF
        checkpoints force [startoftranscript, language, task,
        notimestamps]); the prefix is not part of the returned ids.
        ``suppress`` masks logits at every step; ``begin_suppress`` only at
        the first generated position (HF semantics — e.g. EOT can't be the
        whole transcript)."""
        enc = self.encode(log_mel_spectrogram(audio))
        prefix = [int(sot)] if isinstance(sot, int) else [int(t) for t in sot]
        return self.generate(enc, prefix, eot, max_tokens, suppress,
                             begin_suppress)


def whisper_config_from_hf(path: str) -> WhisperConfig:
    """Build a WhisperConfig from a local HF checkpoint's config.json."""
    import json
    import os

    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    if cfg.get("model_type") != "whisper":
        raise ValueError(f"{path} is not a whisper checkpoint")
    return WhisperConfig(
        name=path,
        vocab_size=cfg.get("vocab_size", 51865),
        d_model=cfg.get("d_model", 768),
        encoder_layers=cfg.get("encoder_layers", 12),
        decoder_layers=cfg.get("decoder_layers", 12),
        num_heads=cfg.get("encoder_attention_heads", 12),
        max_target_len=cfg.get("max_target_positions", 448),
        n_mels=cfg.get("num_mel_bins", N_MELS),
        n_audio_ctx=cfg.get("max_source_positions", N_FRAMES // 2),
    )


def get_whisper_config(model: str) -> WhisperConfig:
    import os

    if os.path.isdir(model) and os.path.exists(
            os.path.join(model, "config.json")):
        return whisper_config_from_hf(model)
    key = model.split("/")[-1].lower()
    aliases = {"whisper-small": "whisper-small",
               "whisper-tiny": "tiny-whisper",
               "tiny-whisper": "tiny-whisper"}
    if key in aliases:
        return WHISPER_PRESETS[aliases[key]]
    raise ValueError(
        f"Unknown whisper model {model!r}; presets: "
        f"{sorted(WHISPER_PRESETS)}")


def is_whisper_model(model: str) -> bool:
    import json
    import os

    cfg_path = os.path.join(model, "config.json")
    if os.path.isdir(model) and os.path.exists(cfg_path):
        try:
            with open(cfg_path) as f:
                return json.load(f).get("model_type") == "whisper"
        except (OSError, ValueError):
            return False
    return "whisper" in model.split("/")[-1].lower()
