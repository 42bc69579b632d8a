"""qwen3-1.7b — dense decoder with qk_norm + GQA [hf:Qwen/Qwen3-8B family].

28 layers, d_model=2048, 16 heads (GQA kv=8), d_ff=6144, vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=6144,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    param_dtype="float32",
    hfl_topology=(8, 8, 1, 4),
    source="hf:Qwen/Qwen3-8B",
))
