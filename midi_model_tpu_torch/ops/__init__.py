"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

- ``sampler``        : top-p/top-k Gumbel-argmax sampler;
- ``paged_allheads`` : paged KV pools and paged flash decode with append;
- ``attention``      : dense reference attention and causal attention;
- ``_build``         : nvcc build, ctypes binding and launch counters.
"""
