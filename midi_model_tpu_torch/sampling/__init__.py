"""Grammar-masked top-p/top-k generation over paged KV pools."""

from .generate import (GenState, decode_events, generate, mask_tensors,
                       normalize_prompt, prefill)
from .masks import MaskTable, build_allow_vector, build_mask_table
from .topk_topp import (K_CAP, gumbel_rows, sample_greedy, sample_top_p_k,
                        slot_gumbel)

__all__ = ["GenState", "K_CAP", "MaskTable", "build_allow_vector",
           "build_mask_table", "decode_events", "generate", "gumbel_rows",
           "mask_tensors", "normalize_prompt", "prefill", "sample_greedy",
           "sample_top_p_k", "slot_gumbel"]
