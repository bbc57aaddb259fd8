"""The port's ``MIDIModel`` facade on the CPU, mirroring ``tests/test_api.py``
case for case, and held to the JAX package's ``MIDIModel``: a directory
written by the JAX ``save_pretrained`` loads into the port with the same
weights and the same greedy rows, before and after a peft adapter merge."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from midi_model_tpu.models import MIDIModel as JaxMIDIModel
from midi_model_tpu.models import lora as jlora
from midi_model_tpu_torch.interop import save_file, to_jax_tree
from midi_model_tpu_torch.models import MIDIModel
from midi_model_tpu_torch.models.lora import init_lora, lora_to_peft_state_dict

from _torch_helpers import one_torch_thread, tiny_configs, tiny_models  # noqa: F401


@pytest.fixture(scope="module")
def model():
    return MIDIModel(tiny_configs()[1], dtype=torch.float32, device="cpu")


def test_forward_and_generate(model):
    x = np.random.default_rng(0).integers(0, model.tokenizer.vocab_size, (1, 4, 8))
    hidden, _ = model.forward(x)
    assert hidden.shape == (1, 4, model.config.n_embd)
    logits, _ = model.forward_token(hidden[:, -1], x[:, 0, :4])
    assert logits.shape == (1, 5, model.tokenizer.vocab_size)
    out = model.generate(batch_size=2, max_len=6, seed=1)
    assert out.shape[0] == 2 and out.shape[2] == 8
    assert model.param_count() > 0 and model.device.type == "cpu"


def test_save_load_roundtrip(model, tmp_path):
    out = tmp_path / "ckpt"
    model.save_pretrained(str(out))
    assert (out / "config.json").exists()
    loaded = MIDIModel.from_pretrained(str(out), dtype=torch.float32, device="cpu")
    a = model.generate(batch_size=1, max_len=5, greedy=True)
    b = loaded.generate(batch_size=1, max_len=5, greedy=True)
    np.testing.assert_array_equal(a, b)


def test_lora_merge(model, tmp_path):
    params = dict(model.model.named_parameters())
    gen = torch.Generator()
    gen.manual_seed(5)
    lora = init_lora(params, gen, rank=2)
    key = "net.layers.0.self_attn.q_proj.lora_B.weight"
    lora[key] = torch.ones_like(lora[key]) * 0.01
    path = tmp_path / "adapter_model.safetensors"
    save_file(lora_to_peft_state_dict(lora), str(path))

    w = model.model.net.layers[0].self_attn.q_proj.weight
    before = w.detach().clone()
    model.load_merge_lora(str(path))
    assert (w.detach() - before).abs().max() > 1e-5


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """A directory written by the JAX package's ``save_pretrained`` (f32
    weights of the shared tiny model) and its JAX model."""
    jcfg, _, params, _, _ = tiny_models(seed=2)
    jmodel = JaxMIDIModel(jcfg, params)
    out = tmp_path_factory.mktemp("jax_saved")
    jmodel.save_pretrained(str(out))
    return jmodel, out


def test_from_pretrained_of_jax_directory(jax_saved):
    """Same weights; greedy rows identical to the JAX model's."""
    jmodel, out = jax_saved
    model = MIDIModel.from_pretrained(str(out), dtype=torch.float32, device="cpu")
    assert model.model.dtype == torch.float32
    ours = to_jax_tree(dict(model.model.named_parameters()), model.config)
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jmodel.params)[0]}
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(ours)[0]}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rows = model.generate(batch_size=2, max_len=8, greedy=True)
    np.testing.assert_array_equal(rows, jmodel.generate(batch_size=2, max_len=8, greedy=True))
    # the default dtype is bf16, as the JAX class's
    assert MIDIModel.from_pretrained(str(out), device="cpu").model.dtype == torch.bfloat16


def test_merged_adapter_greedy_rows_match_jax(jax_saved, tmp_path):
    """The same peft adapter merged by both packages' ``load_merge_lora``:
    greedy rows identical."""
    jmodel, out = jax_saved
    jl = jlora.init_lora(jax.random.PRNGKey(3), jmodel.params, rank=2)
    for net in jl.values():
        for ab in net.values():
            ab["b"] = jnp.full_like(ab["b"], 0.05)
    path = tmp_path / "adapter_model.safetensors"
    save_file(jlora.lora_to_peft_state_dict(jl), str(path))
    jmerged = JaxMIDIModel(jmodel.config, jmodel.params).load_merge_lora(str(path), alpha=4.0)
    model = MIDIModel.from_pretrained(str(out), dtype=torch.float32, device="cpu")
    model.load_merge_lora(str(tmp_path), alpha=4.0)  # a directory holding the file
    rows = model.generate(batch_size=2, max_len=8, greedy=True)
    np.testing.assert_array_equal(rows, jmerged.generate(batch_size=2, max_len=8, greedy=True))
