"""deepseek-7b — llama-architecture dense decoder [arXiv:2401.02954].

30 layers, d_model=4096, 32 heads (MHA: kv=32), d_ff=11008, vocab=102400.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_head=128,
    d_ff=11008,
    vocab=102400,
    rope_theta=1e4,
    param_dtype="float32",
    hfl_topology=(4, 8, 1, 8),
    source="arXiv:2401.02954",
))
