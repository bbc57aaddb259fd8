"""Checkpoint interop: reference-layout state dicts, JAX pytrees and a
jax-free ``.safetensors`` reader and writer."""

from .safetensors_io import load_file, save_file
from .torch_ckpt import (from_jax_params, load_state_dict,
                         params_from_state_dict, state_dict_from_params,
                         synthesize_state_dict, to_jax_tree)

__all__ = ["from_jax_params", "load_file", "load_state_dict", "params_from_state_dict",
           "save_file", "state_dict_from_params", "synthesize_state_dict", "to_jax_tree"]
