"""midi_model_tpu_torch — the PyTorch + CUDA port of ``midi_model_tpu``.

The JAX package beside it stays the reference; this package imports
``torch`` and never ``jax`` (not even transitively: of the JAX package it
uses only the framework-free ``tokenizer`` and ``midi`` modules).

- ``models``   : config dataclasses, Llama stack and the hierarchical MIDINet
                 as ``nn.Module``s (same layouts as the JAX package).
- ``ops``      : hand-written CUDA kernels (``csrc/``) with their plain
                 PyTorch versions: top-p/top-k sampler, paged flash decode
                 with append, causal attention forward.
- ``sampling`` : grammar mask tables, top-p/top-k sampling and batched
                 generation over paged KV pools.
- ``interop``  : reference-layout state dicts and JAX parameter pytrees.

Dispatch rule for every kernel wrapper: a CPU tensor runs the plain
PyTorch version; a CUDA tensor launches the kernel or raises.
"""

__version__ = "0.1.0"
