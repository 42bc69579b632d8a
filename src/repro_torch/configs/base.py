"""Architecture config system; the port of ``repro.configs.base``.

Every assigned architecture is a frozen dataclass instance registered under
its public id (``--arch <id>``). Configs are *exact* per the assignment
brief; each module cites its source in the per-arch file.

``hfl_topology`` is the Arena-on-TPU mesh factorization (DESIGN.md §3):
(M edges, D fl-devices per edge, F fsdp, T tensor) with M*D*F*T == 256
(one pod). The multi-pod mesh prepends a pod axis of size 2.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    # 'tensor' = every expert sharded over tp axis (grok-1 style);
    # 'expert' = experts partitioned over tp axis + all_to_all (olmoe style).
    parallelism: str = "tensor"
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                      # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    source: str                       # citation from the assignment

    d_head: int = 0                   # 0 -> d_model // n_heads
    # --- attention options -------------------------------------------------
    qk_norm: bool = False             # qwen3
    qkv_bias: bool = False            # qwen2
    rope_theta: float = 1e4
    m_rope: bool = False              # qwen2-vl multimodal rotary
    sliding_window: int = 8192        # used only for long_500k decode of
                                      # full-attention archs (DESIGN.md §4)
    # --- moe ---------------------------------------------------------------
    moe: Optional[MoEConfig] = None
    # --- ssm / hybrid ------------------------------------------------------
    ssm_state: int = 0                # mamba2 N
    ssm_heads: int = 0
    ssm_expand: int = 2
    attn_every: int = 0               # zamba2: shared attn block period
    rwkv: bool = False                # rwkv6 time-mix/channel-mix blocks
    # --- enc-dec (whisper) -------------------------------------------------
    enc_layers: int = 0
    enc_seq: int = 1500               # whisper 30s -> 1500 frames (stub)
    dec_ctx: int = 4096               # learned decoder positions (whisper
                                      # spec is 448; extended so the
                                      # assigned train_4k shape lowers)
    # --- vlm ---------------------------------------------------------------
    vision_tokens: int = 0            # stub patch-embedding count (qwen2-vl)
    # --- numerics / sharding ----------------------------------------------
    param_dtype: str = "float32"
    activ_dtype: str = "bfloat16"
    hfl_topology: Tuple[int, int, int, int] = (4, 4, 1, 16)  # (M, D, F, T)
    tie_embeddings: bool = False
    # reduced smoke variant factory handled by reduce()

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.activ_dtype)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def n_params(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        per_layer = 0
        if self.rwkv:
            # time-mix: r,k,v,g,o (d*d each) + decay/ddlerp low-rank (~small)
            # channel-mix: k (d*f), v (f*d), r (d*d)
            per_layer = 5 * d * d + d * f * 2 + d * d + 8 * d
        elif self.family in ("ssm", "hybrid") and self.ssm_state:
            din = self.ssm_expand * d
            nh = self.ssm_heads or max(din // 64, 1)
            per_layer = d * (2 * din + 2 * self.ssm_state * nh + nh) + din * d
            if self.family == "hybrid":
                pass  # shared attention counted once below
        if self.n_heads and self.family not in ("hybrid",):
            per_layer += d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d
        if self.moe is not None:
            per_layer += d * self.moe.n_experts  # router
            per_layer += self.moe.n_experts * 3 * d * f
        elif self.family not in ("ssm",) and not self.rwkv:
            per_layer += 3 * d * f  # swiglu
        total = self.n_layers * per_layer + v * d * (1 if self.tie_embeddings else 2)
        if self.family == "hybrid" and self.attn_every:
            total += d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d  # one shared block
        if self.enc_layers:
            total += self.enc_layers * (4 * d * d + 2 * d * f)
            total += self.dec_ctx * d        # learned decoder positions
            # decoder cross-attention (qkvo) on top of self-attention
            total += self.n_layers * 4 * d * d
        return total

    def reduce(self) -> "ArchConfig":
        """Reduced same-family variant for CPU smoke tests
        (<=2 layers, d_model<=512, <=4 experts)."""
        d = min(self.d_model, 256)
        nh = min(self.n_heads, 4) if self.n_heads else 0
        nkv = min(self.n_kv_heads, max(1, nh // 2)) if self.n_kv_heads else 0
        moe = None
        if self.moe is not None:
            # capacity_factor = n_experts guarantees no token drops, making
            # decode bit-consistent with the full forward in smoke tests
            moe = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                capacity_factor=float(min(self.moe.n_experts, 4)))
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=d,
            n_heads=nh,
            n_kv_heads=nkv,
            d_head=64 if nh else 0,
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512),
            moe=moe,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            enc_seq=min(self.enc_seq, 32),
            dec_ctx=min(self.dec_ctx, 64),
            vision_tokens=min(self.vision_tokens, 16) if self.vision_tokens else 0,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            sliding_window=min(self.sliding_window, 64),
            param_dtype="float32",
            hfl_topology=(1, 1, 1, 1),
        )


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        # import side-effect registration
        from repro_torch import configs  # noqa: F401
        configs.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_arch_names() -> list[str]:
    from repro_torch import configs
    configs.load_all()
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Input shapes assigned to this paper (system brief).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
