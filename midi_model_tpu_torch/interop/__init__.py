"""Checkpoint interop: reference-layout state dicts and JAX pytrees."""

from .torch_ckpt import (from_jax_params, load_state_dict,
                         params_from_state_dict, state_dict_from_params,
                         synthesize_state_dict)

__all__ = ["from_jax_params", "load_state_dict", "params_from_state_dict",
           "state_dict_from_params", "synthesize_state_dict"]
