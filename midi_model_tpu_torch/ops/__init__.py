"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

- ``sampler``        : top-p/top-k Gumbel-argmax sampler;
- ``paged_allheads`` : paged KV pools (bf16/f32/int8) and paged flash decode
                       with append, per-slot and streaming;
- ``token_loop``     : the token row of one event;
- ``fused_step``     : one event-net step over all layers;
- ``event_loop``     : E whole events per launch, aligned and ragged;
- ``attention``      : dense reference attention and causal attention;
- ``ssm``            : the Mamba-2 scan (prefill) and state update (decode);
- ``hybrid_norm``    : residual add + RMSNorm, and SwiGLU, one launch each;
- ``_build``         : nvcc build, ctypes binding and launch counters.
"""
