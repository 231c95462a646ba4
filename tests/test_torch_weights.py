"""Local checkpoints in the torch port against the JAX loader and engine,
on the CPU: tiny random HF checkpoints written with ``transformers``
``save_pretrained`` (nothing is downloaded), one a architecture.

- the port's ``load_checkpoint`` gives the JAX loader's tree, leaf for
  leaf (names, shapes, float32 values within 1e-6), for Llama, OPT
  (safetensors and ``pytorch_model.bin``) and Mixtral; under int8 the
  engine's weights equal JAX ``quantize_loaded`` of the JAX tree;
- the standard-library safetensors reader and writer against the
  ``safetensors`` package (bf16, f16, f32, int8);
- a missing tensor raises, from the loader and from the engine, and
  never serves drawn weights;
- greedy streams of an engine on the Llama directory equal the JAX
  engine's on it (a prefix hit and a chunked prompt among them), and
  with a draft checkpoint directory so do the speculative streams and
  their counters."""

import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.core import EngineCore as JaxEngineCore
from production_stack_tpu.engine.sampling import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.models import get_model_config as jax_model_config
from production_stack_tpu.models import quantize as jquant
from production_stack_tpu.models import weights as jweights
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import EngineCore
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.models import get_model_config
from production_stack_tpu_torch.models import weights as tweights

from test_torch_engine import _collect

torch.set_num_threads(1)

TOL = 1e-6
ENGINE = dict(dtype="float32", max_model_len=128, max_num_seqs=4,
              block_size=4, num_blocks=96, min_prefill_bucket=16,
              prefill_chunk_size=16, max_loras=0)
GREEDY = dict(temperature=0.0, max_tokens=12, ignore_eos=True)


def _save(model, path, safe=True):
    model.eval()
    model.save_pretrained(path, safe_serialization=safe)
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Tiny random HF checkpoints: {name: directory}."""
    from transformers import (
        LlamaConfig,
        LlamaForCausalLM,
        MixtralConfig,
        MixtralForCausalLM,
        OPTConfig,
        OPTForCausalLM,
    )

    root = tmp_path_factory.mktemp("ckpts")
    torch.manual_seed(0)
    out = {"llama": _save(LlamaForCausalLM(LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, tie_word_embeddings=False)),
        root / "llama")}
    torch.manual_seed(1)
    out["draft"] = _save(LlamaForCausalLM(LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
        max_position_embeddings=256, tie_word_embeddings=True)),
        root / "draft")
    torch.manual_seed(2)
    opt = OPTForCausalLM(OPTConfig(
        vocab_size=128, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=128,
        word_embed_proj_dim=64))
    out["opt"] = _save(opt, root / "opt")
    out["opt_bin"] = _save(opt, root / "opt_bin", safe=False)
    torch.manual_seed(3)
    out["mixtral"] = _save(MixtralForCausalLM(MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=128)), root / "mixtral")
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _np(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:  # compared bit for bit
            leaf = leaf.view(torch.int16)
        return leaf.numpy()
    return np.asarray(leaf)


def _assert_trees_equal(got, want, atol=0.0):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g, w = _np(got[name]), _np(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


def test_has_checkpoint(ckpts, tmp_path):
    for path in ckpts.values():
        assert tweights.has_checkpoint(path) == jweights.has_checkpoint(path)
        assert tweights.has_checkpoint(path)
    assert not tweights.has_checkpoint(str(tmp_path))
    assert not tweights.has_checkpoint(str(tmp_path / "absent"))


@pytest.mark.parametrize("name", ["llama", "draft", "opt", "opt_bin",
                                  "mixtral"])
def test_loaded_tree_matches_jax_loader(ckpts, name):
    path = ckpts[name]
    want = jweights.load_checkpoint(
        jax_model_config(path).replace(dtype="float32"), path)
    cfg = get_model_config(path).replace(dtype="float32")
    got = tweights.load_checkpoint(cfg, path)
    for _, leaf in _flat(got):
        assert leaf.device.type == "cpu" and leaf.is_contiguous()
    _assert_trees_equal(got, want, atol=TOL)
    if name == "draft":
        assert "lm_head" not in got  # tied: the model reads embed.T


def test_bf16_leaves_are_the_checkpoint_rounded(ckpts):
    """At bf16 each leaf is the float32 tensor rounded to nearest even,
    the JAX loader's astype."""
    path = ckpts["llama"]
    want = jweights.load_checkpoint(jax_model_config(path), path)
    got = tweights.load_checkpoint(get_model_config(path), path)
    got_flat, want_flat = dict(_flat(got)), dict(_flat(want))
    for name, w in want_flat.items():
        assert got_flat[name].dtype == torch.bfloat16, name
        w_bits = np.asarray(w).view(np.uint16)
        np.testing.assert_array_equal(
            got_flat[name].view(torch.int16).numpy().view(np.uint16),
            w_bits, err_msg=name)


def test_int8_engine_weights_match_jax_quantize_loaded(ckpts):
    path = ckpts["llama"]
    jtree = jax_model_config(path).replace(dtype="float32")
    want = jquant.quantize_loaded(
        _numpy_tree(jweights.load_checkpoint(jtree, path)), "llama")
    core = EngineCore(EngineConfig(model=path, device="cpu",
                                   quantization="int8", **ENGINE))
    got = core.params
    got_flat = dict(_flat(got))
    for name, w in dict(_flat(want)).items():
        g = _np(got_flat[name])
        assert g.dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    # The loader's own tree, quantized by the port, is the same.
    port = tweights.load_checkpoint(
        get_model_config(path).replace(dtype="float32"), path)
    from production_stack_tpu_torch.models.quantize import quantize_loaded

    _assert_trees_equal(quantize_loaded(port, "llama"), want)


def _numpy_tree(tree):
    """A JAX tree with numpy leaves (the dict structure kept)."""
    return {k: (_numpy_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32, torch.int8])
def test_safetensors_reader_and_writer_against_the_library(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(5)
    src = {"a": torch.randn(3, 7, generator=g), "b": torch.randn(
        11, generator=g), "c": torch.randn(2, 3, 4, generator=g) * 50}
    src = {k: v.to(dtype) for k, v in src.items()}
    src["empty"] = torch.empty(0, 4, dtype=dtype)
    save_file(src, str(tmp_path / "lib.safetensors"))
    got = dict(tweights.read_safetensors(str(tmp_path / "lib.safetensors")))
    tweights.save_safetensors(src, str(tmp_path / "port.safetensors"),
                              metadata={"format": "pt"})
    back = load_file(str(tmp_path / "port.safetensors"))
    for k, v in src.items():
        for other in (got[k], back[k]):
            assert other.dtype == v.dtype and other.shape == v.shape, k
            assert torch.equal(other, v), k


@pytest.mark.parametrize("name", ["llama", "opt", "mixtral"])
def test_hf_tensors_give_back_the_transformers_state_dict(ckpts, name):
    """The loader's inverse names and lays out every tensor as
    ``save_pretrained`` wrote it (OPT's tied head aside)."""
    from safetensors.torch import load_file

    path = ckpts[name]
    cfg = get_model_config(path).replace(dtype="float32")
    got = dict(tweights.hf_tensors(tweights.load_checkpoint(cfg, path),
                                   cfg))
    want = {}
    for f in sorted(__import__("glob").glob(path + "/*.safetensors")):
        want.update(load_file(f))
    want.pop("lm_head.weight" if name == "opt" else "", None)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k


@pytest.mark.parametrize("model", ["tiny-llama", "tiny-opt",
                                   "tiny-mixtral"])
@pytest.mark.parametrize("torch_bin", [False, True])
def test_save_checkpoint_round_trip(tmp_path, model, torch_bin):
    """A drawn tree written by ``save_checkpoint`` (three safetensors
    shards, or one ``pytorch_model.bin``) loads back bit for bit, and its
    config.json gives back the model configuration."""
    from production_stack_tpu_torch.models import build_model

    cfg = get_model_config(model)
    init, _ = build_model(cfg)
    tree = init(cfg, torch.Generator().manual_seed(0), "cpu")
    tree.pop("lora", None)
    path = str(tmp_path / "ckpt")
    tweights.save_checkpoint(tree, cfg, path, shards=3, torch_bin=torch_bin)
    back = get_model_config(path)
    assert back.replace(name=cfg.name) == cfg
    _assert_trees_equal(tweights.load_checkpoint(back, path), tree)


def test_truncated_safetensors_raises(tmp_path):
    path = str(tmp_path / "t.safetensors")
    tweights.save_safetensors({"w": torch.ones(64)}, path)
    with open(path, "r+b") as f:
        f.truncate(f.seek(0, 2) - 8)
    with pytest.raises(ValueError, match="spans bytes"):
        list(tweights.read_safetensors(path))


def test_missing_tensor_fails_loudly(tmp_path):
    """A checkpoint missing layers raises from the loader (the JAX test's
    file) and from the engine: no drawn weights are served."""
    import json

    cfg = get_model_config("tiny-llama")
    tweights.save_safetensors(
        {"model.embed_tokens.weight":
         torch.zeros(cfg.vocab_size, cfg.hidden_size)},
        str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="missing tensors") as port_err:
        tweights.load_checkpoint(cfg, str(tmp_path))
    with pytest.raises(ValueError, match="missing tensors") as jax_err:
        jweights.load_checkpoint(jax_model_config("tiny-llama"),
                                 str(tmp_path))
    assert str(port_err.value) == str(jax_err.value)
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "intermediate_size": cfg.intermediate_size}))
    with pytest.raises(ValueError, match="missing tensors"):
        EngineCore(EngineConfig(model=str(tmp_path), device="cpu",
                                **ENGINE))


class CheckpointPair:
    """The JAX engine and the port's engine, each loading ``model`` (and
    the drafter, when configured) from disk."""

    def __init__(self, **kwargs):
        import jax

        kwargs = dict(ENGINE, **kwargs)
        self.jax = JaxEngineCore(JaxEngineConfig(**kwargs),
                                 devices=jax.devices()[:1])
        self.torch = EngineCore(EngineConfig(device="cpu", **kwargs))
        self.jax.start()
        self.torch.start()

    def run(self, prompts, **sampling):
        return (_collect(self.jax, prompts, JaxSamplingParams(**sampling),
                         True),
                _collect(self.torch, prompts, SamplingParams(**sampling),
                         True))

    def stop(self):
        self.jax.stop()
        self.torch.stop()


def test_served_checkpoint_greedy_streams_match_jax(ckpts):
    path = ckpts["llama"]
    pair = CheckpointPair(model=path)
    try:
        # The port serves the file's weights, not the draw.
        loaded = tweights.load_checkpoint(
            get_model_config(path).replace(dtype="float32"), path)
        _assert_trees_equal(pair.torch.params, loaded)
        long_prompt = [int(t) for t in np.random.default_rng(0).integers(
            1, 128, size=40)]  # three 16-token chunks
        prompts = [[3, 14, 15, 92, 65, 35, 89, 79], long_prompt,
                   list(range(20, 31))]
        want, got = pair.run(prompts, **GREEDY)
        assert got == want
        assert all(f == "length" for _, f in got)
        # A prefix hit on the long prompt's cached pages.
        want, got = pair.run([long_prompt[:36] + [7, 9]], **GREEDY)
        assert got == want
        assert pair.torch.cached_tokens_total > 0
        assert (pair.torch.cached_tokens_total
                == pair.jax.cached_tokens_total)
    finally:
        pair.stop()


def test_draft_checkpoint_spec_streams_match_jax(ckpts):
    pair = CheckpointPair(model=ckpts["llama"],
                          speculative_draft_model=ckpts["draft"],
                          speculative_num_tokens=4)
    try:
        drafter = pair.torch._draft
        loaded = tweights.load_checkpoint(
            get_model_config(ckpts["draft"]).replace(dtype="float32"),
            ckpts["draft"])
        _assert_trees_equal(drafter.params, loaded)
        prompts = [[5, 6, 7, 5, 6, 7, 5, 6], list(range(40, 58))]
        want, got = pair.run(prompts, **dict(GREEDY, max_tokens=16))
        assert got == want
        ts, js = pair.torch.stats(), pair.jax.stats()
        for key in ("spec_proposed_tokens_total",
                    "spec_accepted_tokens_total", "spec_verify_bursts_total",
                    "spec_draft_forward_steps_total",
                    "decode_forward_steps_total"):
            assert ts[key] == js[key], key
        assert ts["spec_proposed_by_source"]["draft_model"] > 0
    finally:
        pair.stop()
