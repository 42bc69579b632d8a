"""phi3-medium-14b — dense decoder, RoPE + SwiGLU + GQA [arXiv:2404.14219].

40 layers, d_model=5120, 40 heads (GQA kv=10), d_ff=17920, vocab=100352.
40 Q / 10 KV heads are padded to 48/16 for the 16-way tensor axis (waste is
accounted in the roofline useful-FLOP ratio; see EXPERIMENTS.md §Perf).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_head=128,
    d_ff=17920,
    vocab=100352,
    rope_theta=1e4,
    param_dtype="float32",
    hfl_topology=(4, 4, 1, 16),
    source="arXiv:2404.14219",
))
