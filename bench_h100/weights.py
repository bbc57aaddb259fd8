"""Random weights in the upstream state-dict layout (``net.*``,
``net_token.*``, ``lm_head.weight``), made on the device from the seed: one
normal draw for every matrix and embedding at once (std ``init_std``), norm
scales 1.  The same seed gives the same weights, so the reference can make
them again after the program's state is freed."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def layout(config: dict) -> List[Tuple[str, tuple]]:
    out = []
    vocab = config["tokenizer"]["vocab_size"]
    for prefix, key in (("net", "net_config"), ("net_token", "net_token_config")):
        c = config[key]
        d, h = c["hidden_size"], c["num_attention_heads"]
        hkv = c.get("num_key_value_heads") or h
        dh = c.get("head_dim") or d // h
        f = c["intermediate_size"]
        out.append((f"{prefix}.embed_tokens.weight", (vocab, d)))
        for i in range(c["num_hidden_layers"]):
            pre = f"{prefix}.layers.{i}."
            out += [(pre + "self_attn.q_proj.weight", (h * dh, d)),
                    (pre + "self_attn.k_proj.weight", (hkv * dh, d)),
                    (pre + "self_attn.v_proj.weight", (hkv * dh, d)),
                    (pre + "self_attn.o_proj.weight", (d, h * dh)),
                    (pre + "mlp.gate_proj.weight", (f, d)),
                    (pre + "mlp.up_proj.weight", (f, d)),
                    (pre + "mlp.down_proj.weight", (d, f)),
                    (pre + "input_layernorm.weight", (d,)),
                    (pre + "post_attention_layernorm.weight", (d,))]
        out.append((f"{prefix}.norm.weight", (d,)))
    out.append(("lm_head.weight", (vocab, config["net_config"]["hidden_size"])))
    return out


def make(config: dict, seed: int, dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    shapes = layout(config)
    mats = [(n, s) for n, s in shapes if len(s) == 2]
    total = sum(s[0] * s[1] for _, s in mats)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(0.0, config["init_std"], generator=gen)
    out, at = {}, 0
    for n, s in mats:
        out[n] = flat[at:at + s[0] * s[1]].view(s)
        at += s[0] * s[1]
    for n, s in shapes:
        if len(s) == 1:
            out[n] = torch.ones(s, dtype=dtype, device=device)
    return out
