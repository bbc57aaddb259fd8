"""The port's publisher (``midi_model_tpu_torch.interop.publish``) and its
peft adapter export on the CPU: a run directory of the port's trainer and
a flat checkpoint published in bf16 and fp32 reload with the run's weights
(fp32 exactly, bf16 as torch's rounding of them); the Hub push is refused;
``adapter_config.json`` and ``adapter_model.safetensors`` equal the JAX
package's ``export_peft_adapter`` output for the same adapter."""

import json

import numpy as np
import pytest
import torch

import jax

from midi_model_tpu.models import lora as jlora
from midi_model_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from midi_model_tpu_torch.interop import load_file, load_state_dict, save_file
from midi_model_tpu_torch.interop.publish import load_any_checkpoint, main, publish
from midi_model_tpu_torch.models import MIDIModel, MIDIModelConfig
from midi_model_tpu_torch.models.lora import peft_state_dict_to_lora
from midi_model_tpu_torch.train import init_params, init_train_state, make_optimizer
from midi_model_tpu_torch.train.checkpoint import CheckpointManager

from _torch_helpers import TINY, one_torch_thread, tiny_models  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory holding one save of a tiny model's train state, and
    its config file."""
    cfg = MIDIModelConfig.get_config("v2", True, **TINY)
    root = tmp_path_factory.mktemp("run")
    config_path = root / "tiny_config.json"
    config_path.write_text(json.dumps(cfg.to_dict()))
    opt = make_optimizer()
    state = init_train_state(init_params(cfg, seed=11, device="cpu"), opt)
    mgr = CheckpointManager(str(root / "checkpoints"), cfg)
    mgr.save(3, state, metrics={"loss": 2.0})
    return cfg, str(config_path), root / "checkpoints", state.params


@pytest.mark.parametrize("dtype", ["bf16", "fp32", "fp16"])
def test_publish_run_directory_round_trip(run_dir, tmp_path, dtype):
    cfg, config_path, ckpt, params = run_dir
    out = publish(str(ckpt), config_path, str(tmp_path / "pub"), dtype=dtype, device="cpu")
    sd = load_file(f"{out}/model.safetensors")
    assert sorted(sd) == sorted(params)
    want_dtype = {"bf16": torch.bfloat16, "fp32": torch.float32, "fp16": torch.float16}[dtype]
    for n, p in params.items():
        np.testing.assert_array_equal(sd[n], p.detach().to(want_dtype).float().numpy(), n)
    assert MIDIModelConfig.from_json_file(f"{out}/config.json").to_dict() == cfg.to_dict()
    loaded = MIDIModel.from_pretrained(out, dtype=torch.float32, device="cpu")
    got = dict(loaded.model.named_parameters())
    for n, p in params.items():
        np.testing.assert_array_equal(got[n].detach().numpy(), sd[n], n)


def test_publish_flat_file_and_cli(run_dir, tmp_path):
    cfg, config_path, ckpt, params = run_dir
    flat = tmp_path / "flat.safetensors"
    save_file(params, str(flat))
    model = load_any_checkpoint(str(flat), cfg, device="cpu")
    from_run = load_any_checkpoint(str(ckpt), cfg, device="cpu")
    for n, p in model.named_parameters():
        assert torch.equal(p, params[n].detach()) and torch.equal(
            dict(from_run.named_parameters())[n], p), n
    main(["--ckpt", str(flat), "--config", config_path, "--out", str(tmp_path / "cli"),
          "--dtype", "fp32", "--device", "cpu"])
    sd = load_state_dict(str(tmp_path / "cli" / "model.safetensors"))
    for n, p in params.items():
        np.testing.assert_array_equal(sd[n], p.detach().numpy(), n)


def test_hub_push_is_refused(run_dir, tmp_path):
    _, config_path, ckpt, _ = run_dir
    with pytest.raises(ValueError, match="network"):
        publish(str(ckpt), config_path, str(tmp_path / "pub"), repo_id="user/model",
                device="cpu")
    assert not (tmp_path / "pub").exists()


def test_peft_adapter_export_matches_jax(tmp_path):
    """The same adapter through both packages' ``export_peft_adapter``: the
    same ``adapter_config.json`` and the same tensors under the same keys."""
    jcfg, cfg, params, _, _ = tiny_models(seed=0)
    jl = jlora.init_lora(jax.random.PRNGKey(1), params, rank=4)
    jl = jax.tree.map(lambda x: x + 0.01, jl)
    jdir = JaxCheckpointManager(str(tmp_path / "jax"), jcfg).export_peft_adapter(
        jl, rank=4, alpha=8.0)
    lora = peft_state_dict_to_lora(jlora.lora_to_peft_state_dict(jl), cfg)
    ours = CheckpointManager(str(tmp_path / "port"), cfg).export_peft_adapter(
        lora, rank=4, alpha=8.0)
    assert ours.endswith("adapter")
    configs = [json.loads(open(f"{d}/adapter_config.json").read()) for d in (jdir, ours)]
    assert configs[0] == configs[1]
    theirs, mine = (load_file(f"{d}/adapter_model.safetensors") for d in (jdir, ours))
    assert sorted(theirs) == sorted(mine)
    for k in theirs:
        np.testing.assert_array_equal(mine[k], theirs[k], k)
