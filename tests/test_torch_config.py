"""The torch port's copies of the model and engine configuration stay
equal to the JAX package's (a drifting copy would serve other shapes)."""

import dataclasses
import json

import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.models import config as jax_config
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.models import config as torch_config

torch.set_num_threads(1)


def test_preset_table_equal_field_by_field():
    assert sorted(torch_config._PRESETS) == sorted(jax_config._PRESETS)
    for name, jcfg in jax_config._PRESETS.items():
        assert (dataclasses.asdict(torch_config._PRESETS[name])
                == dataclasses.asdict(jcfg)), name


def test_aliases_equal():
    assert torch_config._ALIASES == jax_config._ALIASES
    for alias in jax_config._ALIASES:
        assert (dataclasses.asdict(torch_config.get_model_config(alias))
                == dataclasses.asdict(jax_config.get_model_config(alias)))


@pytest.mark.parametrize("hf", [
    {"model_type": "llama", "hidden_size": 256, "num_attention_heads": 8,
     "num_key_value_heads": 2, "num_hidden_layers": 3, "vocab_size": 1000,
     "intermediate_size": 512, "rope_theta": 10000.0, "head_dim": None},
    {"model_type": "mistral", "hidden_size": 512, "num_attention_heads": 8,
     "max_position_embeddings": 4096, "rms_norm_eps": 1e-6,
     "tie_word_embeddings": True},
])
def test_hf_config_json_parses_the_same(tmp_path, hf):
    (tmp_path / "config.json").write_text(json.dumps(hf))
    got = torch_config.get_model_config(str(tmp_path))
    want = jax_config.get_model_config(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_torch_dtype_replaces_jnp_dtype():
    cfg = torch_config.get_model_config("meta-llama/Llama-3-8B")
    assert cfg.torch_dtype is torch.bfloat16
    assert cfg.replace(dtype="float32").torch_dtype is torch.float32
    with pytest.raises(ValueError):
        torch_config.get_model_config("no-such-model")


def test_engine_config_is_the_jax_copy_plus_device():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxEngineConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    assert set(ours) == set(jax_fields) | {"device"}
    assert ours["device"] == "cuda"
    # Every default is the JAX engine's (prefill batching and the step
    # recorder included).
    differ = {k for k in jax_fields if ours[k] != jax_fields[k]}
    assert differ == set()
    assert (ours["prefill_batch"], ours["step_recorder"]) == (4, True)
    cfg = EngineConfig(max_model_len=130, block_size=64)
    assert cfg.max_blocks_per_seq == 3
    assert cfg.bucket_for(40) == JaxEngineConfig(
        max_model_len=130).bucket_for(40)
