"""The port's numpy-only config and grammar mask tables equal the JAX
package's originals."""

import dataclasses

import numpy as np
import pytest

from midi_model_tpu.models.config import CONFIG_NAMES as JAX_NAMES
from midi_model_tpu.models.config import MIDIModelConfig as JaxConfig
from midi_model_tpu.sampling import masks as jax_masks
from midi_model_tpu_torch.models.config import CONFIG_NAMES, MIDIModelConfig
from midi_model_tpu_torch.sampling import masks

FLAGS = [
    {},
    dict(disable_patch_change=True, disable_control_change=True,
         disable_channels=[3, 9]),
    dict(disable_eos=True),
    dict(disable_channels=[0], disable_eos=True),
]


def test_config_names_match():
    assert CONFIG_NAMES == JAX_NAMES


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(sorted(f)) or "default")
@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_mask_table_equals_jax(name, flags):
    tok = MIDIModelConfig.from_name(name).tokenizer
    ours = masks.build_mask_table(tok, **flags)
    ref = jax_masks.build_mask_table(JaxConfig.from_name(name).tokenizer, **flags)
    for field in ("first", "steps", "pad_only"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(ref, field))
    assert ours.first_event_id == ref.first_event_id
    assert ours.n_events == ref.n_events


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_allow_vector_equals_jax(name):
    tok = MIDIModelConfig.from_name(name).tokenizer
    flags = dict(disable_patch_change=True, disable_channels=[1, 15])
    np.testing.assert_array_equal(
        masks.build_allow_vector(tok, **flags),
        jax_masks.build_allow_vector(JaxConfig.from_name(name).tokenizer, **flags))


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_from_name_widths_equal_jax(name):
    ours, ref = MIDIModelConfig.from_name(name), JaxConfig.from_name(name)
    for part in ("net", "net_token"):
        a = dataclasses.asdict(getattr(ours, part))
        b = dataclasses.asdict(getattr(ref, part))
        assert a == {k: b[k] for k in a}
        assert getattr(ours, part).head_dim == getattr(ref, part).head_dim
    assert ours.n_embd == ref.n_embd
    assert ours.to_dict() == ref.to_dict()


def test_dict_round_trip():
    cfg = MIDIModelConfig.get_config("v1", False, n_layer=8, n_head=8,
                                     n_embd=256, n_inner=512)
    back = MIDIModelConfig.from_dict(cfg.to_dict())
    assert back.to_dict() == cfg.to_dict()
    for part in ("net", "net_token"):
        # the HF dict names the kv heads explicitly
        assert dataclasses.replace(getattr(back, part), num_kv_heads=None) == getattr(cfg, part)
    # the JAX package reads the port's dict and vice versa
    assert JaxConfig.from_dict(cfg.to_dict()).to_dict() == cfg.to_dict()


def test_unknown_names_raise():
    with pytest.raises(ValueError):
        MIDIModelConfig.from_name("tv3-medium")
    with pytest.raises(ValueError):
        MIDIModelConfig.from_name("tv2-huge")
