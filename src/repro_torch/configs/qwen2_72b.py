"""qwen2-72b — dense decoder, GQA with QKV bias [arXiv:2407.10671].

80 layers, d_model=8192, 64 heads (GQA kv=8), d_ff=29568, vocab=152064.
bf16 params + fsdp=2 x tp=16 (DESIGN.md §3) to fit 16 GB/chip.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    param_dtype="bfloat16",
    hfl_topology=(4, 2, 2, 16),
    source="arXiv:2407.10671",
))
