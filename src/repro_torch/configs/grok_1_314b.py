"""grok-1-314b — MoE, 8 experts top-2 [hf:xai-org/grok-1].

64 layers, d_model=6144, 48 heads (GQA kv=8), d_ff=32768 per expert,
vocab=131072. Experts use *tensor* parallelism (each expert's d_ff sharded
over the tp axis) — 8 experts don't divide the 16-way axis, and at
d_ff=32768 the per-shard matmul stays MXU-sized. bf16 params + 256-way
(fsdp 16 × tp 16) sharding: one pod holds exactly ONE 314B replica, so the
HFL hierarchy degenerates to the pod level on a single pod (M=1) and the
edge/cloud split appears on the multi-pod mesh (pods = edges) — DESIGN.md
§3/§Arch-applicability.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=32768,
    vocab=131072,
    moe=MoEConfig(n_experts=8, top_k=2, parallelism="tensor"),
    rope_theta=1e4,
    param_dtype="bfloat16",
    hfl_topology=(1, 1, 16, 16),
    source="hf:xai-org/grok-1",
))
