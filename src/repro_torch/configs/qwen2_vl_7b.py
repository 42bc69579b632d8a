"""qwen2-vl-7b — VLM language backbone with M-RoPE [arXiv:2409.12191].

28 layers, d_model=3584, 28 heads (GQA kv=4), d_ff=18944, vocab=152064.
The vision tower (ViT + projector, dynamic resolution) is a STUB per the
assignment: ``input_specs`` provides precomputed patch embeddings
(batch, vision_tokens, d_model) interleaved before the text tokens.
M-RoPE decomposes rotary position into (temporal, height, width) groups.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_head=128,
    d_ff=18944,
    vocab=152064,
    m_rope=True,
    vision_tokens=256,      # stub: 16x16 patch grid per image
    rope_theta=1e6,
    param_dtype="float32",
    hfl_topology=(4, 8, 1, 8),
    source="arXiv:2409.12191",
))
