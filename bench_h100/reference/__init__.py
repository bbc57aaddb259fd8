"""The benchmark's plain reference of SkyTNT's midi-model, in float32 PyTorch.

Written from the upstream model's description (SkyTNT/midi-model,
``midi_model.py`` and ``midi_tokenizer.py``): it imports neither ``jax``
nor the JAX package nor anything of the program under test, and takes the
weights and inputs that the benchmark makes, never anything the program
derived from them.  ``model.py`` is the Llama family's architecture module;
the judge, the grammar, AdamW and the fp8 rounding serve every architecture.
"""
