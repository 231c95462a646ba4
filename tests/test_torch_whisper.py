"""The port's Whisper model (``production_stack_tpu_torch/models/
whisper.py``) against the JAX one, on the CPU.

- the host audio path: WAV decoding (sample widths 1, 2 and 4, stereo,
  8 kHz resampled) and the log-mel frontend bit-equal to JAX's;
- tiny-whisper at float32 with the JAX parameters carried across
  (``whisper_params_from_numpy``): encoder states and decoder logits
  within 1e-4, greedy tokens equal with and without ``suppress`` /
  ``begin_suppress`` and with a forced prefix; bf16 logits within 6e-2;
- ``load_whisper_checkpoint`` against the JAX loader on one HF checkpoint
  (built as tests/test_asr.py builds it; leaves equal), the port's logits
  against ``transformers`` at 3e-4, the port's writer read back bit for
  bit, and a missing tensor raising."""

import dataclasses
import io
import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.models import whisper as jw
from production_stack_tpu.models.weights import (
    load_whisper_checkpoint as jax_load_whisper,
)
from production_stack_tpu_torch.models import whisper as tw
from production_stack_tpu_torch.models.convert import (
    whisper_params_from_numpy,
)
from production_stack_tpu_torch.models.weights import (
    load_whisper_checkpoint,
    save_whisper_checkpoint,
)

torch.set_num_threads(1)

TOL = 1e-4
BF16_TOL = 6e-2


def _wav(pcm: np.ndarray, width: int, channels: int, rate: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _samples(width: int, n: int, rng) -> np.ndarray:
    x = rng.uniform(-0.9, 0.9, n)
    if width == 1:
        return (x * 127 + 128).astype(np.uint8)
    if width == 2:
        return (x * 32767).astype("<i2")
    return (x * 2147483647).astype("<i4")


@pytest.mark.parametrize("width,channels,rate", [
    (2, 1, 16000), (1, 1, 16000), (4, 1, 16000), (2, 2, 16000),
    (2, 1, 8000), (4, 2, 8000)])
def test_wav_decoding_and_mel_equal_jax(width, channels, rate):
    rng = np.random.default_rng(width * 10 + channels + rate)
    data = _wav(_samples(width, rate * channels // 2, rng), width, channels,
                rate)
    got, want = tw.decode_wav_bytes(data), jw.decode_wav_bytes(data)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tw.log_mel_spectrogram(got),
                                  jw.log_mel_spectrogram(want))
    with pytest.raises(Exception):
        tw.decode_wav_bytes(b"not a wav file")


def test_filterbank_sinusoids_and_configs_equal_jax():
    np.testing.assert_array_equal(tw._mel_filterbank(), jw._mel_filterbank())
    np.testing.assert_array_equal(tw._sinusoids(1500, 768),
                                  jw._sinusoids(1500, 768))
    for name in ("tiny-whisper", "whisper-small", "openai/whisper-small",
                 "whisper-tiny"):
        assert (dataclasses.asdict(tw.get_whisper_config(name))
                == dataclasses.asdict(jw.get_whisper_config(name)))
        assert tw.is_whisper_model(name) and jw.is_whisper_model(name)
    assert not tw.is_whisper_model("tiny-llama")
    with pytest.raises(ValueError, match="Unknown whisper model"):
        tw.get_whisper_config("tiny-llama")


@pytest.fixture(scope="module")
def tiny():
    """tiny-whisper: the JAX init at float32 and bf16, each carried into
    the port, and a second of seeded noise."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jw.WHISPER_PRESETS["tiny-whisper"],
                                   dtype=dtype)
        tcfg = dataclasses.replace(tw.WHISPER_PRESETS["tiny-whisper"],
                                   dtype=dtype)
        params = jw.init_whisper_params(jcfg, 0)
        tparams = whisper_params_from_numpy(
            jax.tree.map(np.asarray, params), tcfg, "cpu")
        out[dtype] = (jcfg, params, tcfg, tparams)
    pcm = np.random.default_rng(3).normal(0, 0.1, 16000).astype(np.float32)
    return out, pcm


def test_init_has_the_jax_shapes(tiny):
    for dtype, (jcfg, params, tcfg, _) in tiny[0].items():
        mine = tw.init_whisper_params(tcfg, 0, "cpu")
        want = jax.tree_util.tree_flatten_with_path(params)[0]
        got = jax.tree_util.tree_flatten_with_path(
            mine, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
        assert [p for p, _ in got] == [p for p, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert tuple(a.shape) == b.shape
            assert a.dtype == tcfg.torch_dtype
    again = tw.init_whisper_params(tcfg, 0, "cpu")
    assert torch.equal(again["tok_emb"], mine["tok_emb"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_and_logits_match_jax(tiny, dtype):
    (jcfg, params, tcfg, tparams), pcm = tiny[0][dtype], tiny[1]
    mel = jw.log_mel_spectrogram(pcm)
    j_enc = jw.encode_audio(params, jcfg, jnp.asarray(mel))
    t_enc = tw.encode_audio(tparams, tcfg, mel)
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(t_enc.float().numpy(),
                               np.asarray(j_enc, np.float32),
                               rtol=tol, atol=tol)
    for prefix in ([256], [256, 7, 99, 42], list(range(260, 300))):
        buf = np.zeros((jcfg.max_target_len,), np.int32)
        buf[:len(prefix)] = prefix
        want = np.asarray(jw.decoder_logits(
            params, jcfg, jnp.asarray(buf), jnp.int32(len(prefix)), j_enc))
        got = tw.decoder_logits(tparams, tcfg, buf, len(prefix), enc=t_enc)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", [
    dict(), dict(sot=[256, 7, 99]), "suppress", "begin_suppress"])
def test_greedy_tokens_equal_jax(tiny, case):
    (jcfg, params, tcfg, tparams), pcm = tiny[0]["float32"], tiny[1]
    jmodel = jw.WhisperModel(jcfg, params=params)
    tmodel = tw.WhisperModel(tcfg, params=tparams, device="cpu")
    kwargs = dict(sot=256, eot=257, max_tokens=10)
    base = jmodel.transcribe_tokens(pcm, **kwargs)
    assert base
    if case == "suppress":
        kwargs["suppress"] = tuple(base[:2])
    elif case == "begin_suppress":
        kwargs["begin_suppress"] = (base[0],)
    else:
        kwargs.update(case)
    want = jmodel.transcribe_tokens(pcm, **kwargs)
    got = tmodel.transcribe_tokens(pcm, **kwargs)
    assert got == want
    if case == "suppress":
        assert not set(got) & set(base[:2])
    if case == "begin_suppress":
        assert got[0] != base[0]


def test_eot_stops_and_the_limit_holds(tiny):
    (_, _, tcfg, tparams), pcm = tiny[0]["float32"], tiny[1]
    model = tw.WhisperModel(tcfg, params=tparams, device="cpu")
    base = model.transcribe_tokens(pcm, sot=256, eot=257, max_tokens=6)
    assert len(base) == 6
    # The first generated token as EOT: nothing is returned.
    assert model.transcribe_tokens(pcm, sot=256, eot=base[0]) == []
    # A prefix that fills all but two positions caps the output at two.
    prefix = [256] * (tcfg.max_target_len - 2)
    assert len(model.transcribe_tokens(pcm, sot=prefix, eot=257,
                                       max_tokens=64)) == 2


# -- checkpoints -------------------------------------------------------------

@pytest.fixture(scope="module")
def whisper_ckpt(tmp_path_factory):
    """The HF checkpoint of tests/test_asr.py: d 64, FFN 128, 4 heads."""
    from transformers import WhisperConfig as HFWhisperConfig
    from transformers import WhisperForConditionalGeneration

    torch.manual_seed(0)
    cfg = HFWhisperConfig(
        vocab_size=256, d_model=64, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4,
        decoder_ffn_dim=128, encoder_ffn_dim=128, num_mel_bins=80,
        max_source_positions=1500, max_target_positions=448,
        decoder_start_token_id=250, eos_token_id=251, pad_token_id=252,
        suppress_tokens=[], begin_suppress_tokens=[],
        forced_decoder_ids=None,
    )
    model = WhisperForConditionalGeneration(cfg)
    model.eval()
    model.generation_config.suppress_tokens = None
    model.generation_config.begin_suppress_tokens = None
    model.generation_config.forced_decoder_ids = None
    path = tmp_path_factory.mktemp("whisper-ckpt")
    model.save_pretrained(path, safe_serialization=True)
    return str(path), model


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def test_checkpoint_leaves_equal_the_jax_loader(whisper_ckpt):
    path, _ = whisper_ckpt
    assert tw.is_whisper_model(path)
    tcfg = dataclasses.replace(tw.get_whisper_config(path), dtype="float32")
    jcfg = dataclasses.replace(jw.get_whisper_config(path), dtype="float32")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    got = dict(_leaves(load_whisper_checkpoint(tcfg, path)))
    want = dict(_leaves(jax.tree.map(np.asarray,
                                     jax_load_whisper(jcfg, path))))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # The FFN width comes from the weights (128 at d 64, not 4 x d).
    assert got[".enc_blocks[0].fc1"].shape == (64, 128)


def test_checkpoint_logits_match_transformers(whisper_ckpt):
    path, hf_model = whisper_ckpt
    cfg = dataclasses.replace(tw.get_whisper_config(path), dtype="float32")
    model = tw.WhisperModel(cfg, params=load_whisper_checkpoint(cfg, path),
                            device="cpu")
    pcm = np.random.default_rng(3).normal(0, 0.1, 16000).astype(np.float32)
    mel = tw.log_mel_spectrogram(pcm)
    prefix = [250, 7, 99, 42]
    enc = model.encode(mel)
    ours = tw.decoder_logits(model.params, cfg, prefix, len(prefix),
                             enc=enc).numpy()
    with torch.no_grad():
        hf_enc = hf_model.model.encoder(
            torch.asarray(mel[None])).last_hidden_state[0].numpy()
        theirs = hf_model(
            input_features=torch.asarray(mel[None]),
            decoder_input_ids=torch.asarray([prefix], dtype=torch.long),
        ).logits[0, -1].numpy()
    np.testing.assert_allclose(enc.numpy(), hf_enc, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ours, theirs, rtol=3e-4, atol=3e-4)


def test_writer_round_trip_and_a_missing_tensor_raises(tmp_path, tiny):
    _, _, tcfg, tparams = tiny[0]["float32"]
    path = str(tmp_path / "ckpt")
    nbytes = save_whisper_checkpoint(tparams, tcfg, path)
    assert nbytes == sum(t.numel() * t.element_size()
                         for _, t in _leaves(tparams))
    cfg = dataclasses.replace(tw.get_whisper_config(path), dtype="float32")
    back = dict(_leaves(load_whisper_checkpoint(cfg, path)))
    for k, t in _leaves(tparams):
        assert torch.equal(back[k], t), k
    # The JAX loader reads the port's directory to the same leaves.
    want = dict(_leaves(jax.tree.map(np.asarray, jax_load_whisper(
        dataclasses.replace(jw.get_whisper_config(path), dtype="float32"),
        path))))
    for k, t in back.items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)
    # Drop one tensor: the loader names it.
    from production_stack_tpu_torch.models.weights import (
        read_safetensors,
        save_safetensors,
    )

    st = os.path.join(path, "model.safetensors")
    tensors = {k: v.clone() for k, v in read_safetensors(st)
               if k != "model.decoder.layers.1.encoder_attn.k_proj.weight"}
    save_safetensors(tensors, st)
    with pytest.raises(ValueError, match="encoder_attn.k_proj"):
        load_whisper_checkpoint(cfg, path)
    with open(os.path.join(path, "config.json")) as f:
        assert json.load(f)["model_type"] == "whisper"
