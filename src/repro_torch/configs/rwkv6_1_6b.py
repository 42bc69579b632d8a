"""rwkv6-1.6b — 'Finch', attention-free RNN with data-dependent decay
[arXiv:2404.05892].

24 layers, d_model=2048, d_ff=7168, vocab=65536. Time-mix uses
data-dependent token-shift (ddlerp) + per-channel decay; WKV recurrence is
linear in sequence length (native long_500k support).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,             # wkv heads (head_size 64)
    n_kv_heads=32,
    d_head=64,
    d_ff=7168,
    vocab=65536,
    rwkv=True,
    param_dtype="float32",
    hfl_topology=(8, 8, 1, 4),
    source="arXiv:2404.05892",
))
