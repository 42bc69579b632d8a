"""Public model API: ``build_model(cfg)`` -> ``Model`` with init / loss /
logits / prefill / decode, uniform across every family (``dense``,
``moe``, ``vlm``, ``ssm``, ``hybrid``, ``audio``), and the paper's
testbed CNNs (Arena section 4.1); the port of ``repro.models.model``.
The stub front ends' inputs ride in the batch (``enc_embed`` for
``audio``, ``vision_embed`` for ``vlm``) and in prefill's ``extras``.
``Model.loss`` trains
through the reference's plain tensor math under autograd
(``chunked_attention``, ``wkv_scan`` / ``wkv_chunked``, Mamba2's
``ssd_chunked``, ``chunked_softmax_xent``); ``Model.logits`` and serving
run the kernels.

The CNNs' parameters are plain dicts of tensors in the reference layout:
conv weights HWIO ``(kh, kw, Cin, Cout)``, dense weights ``(in, out)``;
the public functions take NHWC images. The forward permutes to PyTorch's NCHW/OIHW
for ``F.conv2d`` and back to NHWC before flattening, so a reference
parameter dict loads unchanged (``repro_torch.weights``) and the flatten
order of the first dense layer matches. Convolutions and matmuls are
library calls, as the JAX package leaves them to XLA.

Init draws from an explicit ``torch.Generator`` with the law of
``repro.models.common.dense_init``: a normal truncated to [-3, 3], times
``std`` (``scale`` if given, else ``1/sqrt(fan_in)``); biases are zero.
The numbers differ from JAX's threefry draws; tests that need the same
``w(0)`` load the reference's parameters instead.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import common, decode, transformer
from repro_torch.models import tp as tp_mod
from repro_torch.models.common import dense_init


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # ---- parameters -------------------------------------------------------
    def init(self, gen: torch.Generator, device="cuda") -> dict:
        """Random parameters on ``device``, drawn from ``gen`` (a
        generator on the same device type)."""
        return transformer.init_params(gen, self.cfg, resolve_device(device))

    # ---- training ---------------------------------------------------------
    def loss(self, params, batch, *, remat: bool = False,
             ep_axis: Optional[str] = None, ep_size: int = 1,
             attn_chunk: int = 1024, wkv_chunked: bool = False,
             act_spec=None, tp=None, ft=None):
        """batch: {"tokens", "labels"} (B, S) int, plus ``enc_embed`` (audio)
        or ``vision_embed`` (vlm). Returns the scalar f32 loss, ``xent +
        0.01 * aux`` (aux the MoE load-balance loss, 0 without MoE),
        differentiable in ``params`` by autograd; a vlm's loss runs over
        the text positions only. Attention runs ``chunked_attention``
        with KV chunks of ``attn_chunk`` (whisper's blocks: ``min(1024,
        S)``, the reference's), the RWKV6 WKV ``wkv_chunked`` if
        ``wkv_chunked`` else ``wkv_scan``, Mamba2's SSD ``ssd_chunked``;
        no kernel is reached. ``ep_axis`` (expert parallelism) raises in
        an MoE model (item 10 (b)). ``tp``, ``ft`` (``models.tp.
        TPContext``s of the replica's tp and ft groups, ``ft`` defaulting
        to ``tp``): ``params`` are this rank's tensor blocks
        (``transformer.forward_hidden``), the loss vocab-parallel over
        the ft group where the output projection is split; every rank of
        the groups returns the same loss."""
        cfg = self.cfg
        ft = tp if ft is None else ft
        h, aux = transformer.forward_hidden(
            params, cfg, batch["tokens"], extras=_extras(batch),
            remat=remat, ep_axis=ep_axis, ep_size=ep_size,
            attn_chunk=attn_chunk, wkv_chunked=bool(wkv_chunked),
            act_spec=act_spec, tp=tp, ft=ft)
        labels = batch["labels"]
        if cfg.family == "vlm" and "vision_embed" in batch:
            h = h[:, -labels.shape[1]:]     # loss over text positions only
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        xent = common.chunked_softmax_xent(
            h, w, labels, tp=tp_mod.split(ft, w.shape[1], cfg.vocab))
        return xent + 0.01 * aux

    # ---- forward ----------------------------------------------------------
    def logits(self, params, batch, *, window: int = 0):
        """batch: {"tokens": (B, S) int} plus ``enc_embed`` (audio) or
        ``vision_embed`` (vlm). Returns (B, S', vocab) logits in the
        activation dtype, S' = S, or n_vis + S for a vlm given
        ``vision_embed``; ``window`` > 0 is the sliding-window mask."""
        h, _ = transformer.forward_hidden(params, self.cfg, batch["tokens"],
                                          extras=_extras(batch),
                                          window=window)
        return transformer.logits_from_hidden(params, self.cfg, h)

    # ---- serving ----------------------------------------------------------
    # ``tp`` (a ``models.tp.TPContext``): one rank of a serve mesh, the
    # dense family only (``models.decode``, ``launch.serve``)
    def init_cache(self, batch: int, cache_len: int, *, window: int = 0,
                   enc_seq=None, device="cuda", tp=None):
        return decode.init_cache(self.cfg, batch, cache_len, window=window,
                                 enc_seq=enc_seq, device=device, tp=tp)

    def prefill(self, params, tokens, *, extras=None, window: int = 0,
                max_new: int = 0, tp=None):
        return decode.prefill(params, self.cfg, tokens, extras=extras,
                              window=window, max_new=max_new, tp=tp)

    def decode_step(self, params, cache, tokens, *, window: int = 0,
                    tp=None):
        return decode.decode_step(params, self.cfg, cache, tokens,
                                  window=window, tp=tp)


def _extras(batch: dict) -> dict:
    """The stub front ends' inputs of a batch."""
    return {k: batch[k] for k in transformer.EXTRAS if k in batch}


def build_model(cfg: ArchConfig) -> Model:
    """The model of ``cfg``; raises ``ValueError`` for a family the
    reference does not have (``transformer.check_family``)."""
    transformer.check_family(cfg)
    return Model(cfg)


# ===========================================================================
# Paper testbed CNNs (Arena section 4.1)
# ===========================================================================


def _conv2d(x, w, b):
    """x: (B, C, H, W); w: HWIO -> (B, Cout, H', W'), VALID padding."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), b)


def _features(x):
    """NCHW activations -> (B, H*W*C) in the reference's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def mnist_cnn_init(gen: torch.Generator, device="cuda") -> dict:
    """2 conv + 2 fc, 21,840 parameters: conv(1->10, 5x5),
    conv(10->20, 5x5), fc(320->50), fc(50->10)."""
    dev = resolve_device(device)
    z = lambda n: torch.zeros((n,), dtype=torch.float32, device=dev)
    return {
        "c1_w": dense_init(gen, (5, 5, 1, 10), dev, scale=0.1),
        "c1_b": z(10),
        "c2_w": dense_init(gen, (5, 5, 10, 20), dev, scale=0.1),
        "c2_b": z(20),
        "f1_w": dense_init(gen, (320, 50), dev),
        "f1_b": z(50),
        "f2_w": dense_init(gen, (50, 10), dev),
        "f2_b": z(10),
    }


def mnist_cnn_apply(params: dict, x):
    """x: (B, 28, 28, 1) NHWC -> logits (B, 10)."""
    x = x.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(_conv2d(x, params["c1_w"], params["c1_b"])), 2)
    x = F.max_pool2d(F.relu(_conv2d(x, params["c2_w"], params["c2_b"])), 2)
    x = F.relu(_features(x) @ params["f1_w"] + params["f1_b"])
    return x @ params["f2_w"] + params["f2_b"]


def cifar_cnn_init(gen: torch.Generator, device="cuda") -> dict:
    """3 conv + 3 fc, 456,906 parameters: conv(3->32, 5x5),
    conv(32->64, 5x5), conv(64->128, 3x3), fc(1152->256),
    fc(256->128), fc(128->10)."""
    dev = resolve_device(device)
    z = lambda n: torch.zeros((n,), dtype=torch.float32, device=dev)
    return {
        "c1_w": dense_init(gen, (5, 5, 3, 32), dev, scale=0.1),
        "c1_b": z(32),
        "c2_w": dense_init(gen, (5, 5, 32, 64), dev, scale=0.05),
        "c2_b": z(64),
        "c3_w": dense_init(gen, (3, 3, 64, 128), dev, scale=0.05),
        "c3_b": z(128),
        "f1_w": dense_init(gen, (1152, 256), dev),
        "f1_b": z(256),
        "f2_w": dense_init(gen, (256, 128), dev),
        "f2_b": z(128),
        "f3_w": dense_init(gen, (128, 10), dev),
        "f3_b": z(10),
    }


def cifar_cnn_apply(params: dict, x):
    """x: (B, 32, 32, 3) NHWC -> logits (B, 10)."""
    x = x.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(_conv2d(x, params["c1_w"], params["c1_b"])), 2)
    x = F.max_pool2d(F.relu(_conv2d(x, params["c2_w"], params["c2_b"])), 2)
    x = F.relu(_conv2d(x, params["c3_w"], params["c3_b"]))
    x = F.relu(_features(x) @ params["f1_w"] + params["f1_b"])
    x = F.relu(x @ params["f2_w"] + params["f2_b"])
    return x @ params["f3_w"] + params["f3_b"]


def cnn_loss(apply_fn: Callable, params: dict, batch: dict):
    """Mean softmax cross-entropy of ``apply_fn(params, batch["x"])``
    against integer labels ``batch["y"]``."""
    logp = F.log_softmax(apply_fn(params, batch["x"]), dim=-1)
    labels = batch["y"].to(torch.int64)
    return -logp.gather(1, labels[:, None]).mean()


def cnn_accuracy(apply_fn: Callable, params: dict, batch: dict):
    logits = apply_fn(params, batch["x"])
    return (logits.argmax(-1) == batch["y"].to(torch.int64)).to(
        torch.float32).mean()


def count_params(params: dict) -> int:
    return sum(int(p.numel()) for p in params.values())
