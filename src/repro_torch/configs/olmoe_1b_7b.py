"""olmoe-1b-7b — MoE 64 experts top-8 [arXiv:2409.02060].

16 layers, d_model=2048, 16 heads (GQA kv=16), d_ff=1024 per expert,
vocab=50304. Experts use *expert* parallelism: 64 experts over the 16-way
tp axis (4 per device) with all-to-all dispatch/combine — the collective
pattern the roofline tracks for this arch.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1024,
    vocab=50304,
    moe=MoEConfig(n_experts=64, top_k=8, parallelism="expert"),
    rope_theta=1e4,
    param_dtype="float32",
    hfl_topology=(4, 4, 1, 16),
    source="arXiv:2409.02060",
))
