"""midi_model_tpu_torch — the PyTorch + CUDA port of ``midi_model_tpu``.

The JAX package beside it stays the reference; this package imports
``torch`` and never ``jax``, nor any module of the JAX package (it keeps
its own copy of the tokenizer).

- ``tokenizer``: the event tokenizers and vocab tables.
- ``models``   : config dataclasses, Llama stack and the hierarchical MIDINet
                 as ``nn.Module``s (same layouts as the JAX package).
- ``ops``      : hand-written CUDA kernels (``csrc/``) with their plain
                 PyTorch versions: top-p/top-k sampler, paged flash decode
                 with append (per-slot and streaming, bf16/f32/int8 pools),
                 causal attention forward, the token row, the whole
                 event-net step and the event loop (aligned and ragged).
- ``sampling`` : grammar mask tables, top-p/top-k sampling, per-slot noise
                 and batched generation over paged KV pools.
- ``serve``    : the continuous batcher and its streaming service.
- ``interop``  : reference-layout state dicts and JAX parameter pytrees.

Entry points build on the card (``device=None`` is CUDA, and raises when
there is none); the CPU runs only where the caller passes ``device="cpu"``.
Dispatch rule for every kernel wrapper: a CPU tensor runs the plain
PyTorch version; a CUDA tensor launches the kernel or raises.
"""

__version__ = "0.1.0"
