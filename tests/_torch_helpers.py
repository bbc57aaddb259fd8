"""Shared set-up for the PyTorch port's parity tests: one synthesized
reference-layout state dict loaded into both packages."""

import numpy as np
import pytest
import torch

from midi_model_tpu.interop import params_from_state_dict as jax_params_from_sd
from midi_model_tpu.models import MIDIModelConfig as JaxConfig
from midi_model_tpu_torch.interop import params_from_state_dict, synthesize_state_dict
from midi_model_tpu_torch.models import MIDIModelConfig
from midi_model_tpu_torch.models.midinet import MIDINet

# fp32 comparisons here mean full fp32 (no TF32 anywhere)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op threads in each would oversubscribe the cores (a 7 s test took
    minutes), so the port's tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TINY = dict(n_layer=4, n_head=4, n_embd=64, n_inner=128)


def tiny_configs():
    """(JAX config, port config) at the small test size: a 4-layer event
    net and a 1-layer, 1-head token net, 64 wide."""
    return (JaxConfig.get_config("v2", True, **TINY),
            MIDIModelConfig.get_config("v2", True, **TINY))


def layout(config):
    """The reference state-dict layout ``[(name, shape), ...]`` of a config."""
    model = MIDINet(config, device="meta")
    return [(k, tuple(v.shape)) for k, v in model.state_dict().items()]


def tiny_models(seed: int = 0):
    """(JAX config, port config, JAX params, port model, state dict) with
    fp32 weights synthesized from ``seed``."""
    jcfg, cfg = tiny_configs()
    sd = synthesize_state_dict(layout(cfg), seed)
    params = jax_params_from_sd(sd, jcfg)
    return jcfg, cfg, params, params_from_state_dict(sd, cfg, device="cpu"), sd


def to_np(x):
    return np.asarray(x.detach().cpu().float() if isinstance(x, torch.Tensor) else x)
