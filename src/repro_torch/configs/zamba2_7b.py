"""zamba2-7b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242].

81 layers, d_model=3584, 32 heads (GQA kv=32), d_ff=14336, vocab=32000,
ssm_state=64. The Mamba2 backbone is scanned; a single *shared* attention
block (one set of weights) is interleaved every ``attn_every`` layers, per
the Zamba2 design.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=112,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_heads=112,          # expand*d_model / 64 = 7168/64
    ssm_expand=2,
    attn_every=6,           # shared block applied every 6 mamba blocks
    rope_theta=1e4,
    param_dtype="bfloat16",
    hfl_topology=(4, 8, 1, 8),
    source="arXiv:2411.15242",
))
