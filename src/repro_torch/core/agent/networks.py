"""Actor/critic networks (paper 4.1: 2 conv + 3 fc; CNN feature extractor
over the (M+1)x(n_PCA+3) state matrix, Gaussian heads for 2M continuous
actions); the port of ``repro.core.agent.networks``.

Parameters keep the reference's names and layouts (conv weights HWIO,
dense weights ``(in, out)``), so a reference parameter dict loads by
name (``repro_torch.weights.params_from_numpy``). The forward permutes
to PyTorch's NCHW/OIHW for ``F.conv2d`` and flattens the last conv's
activation in the reference's NHWC ``(h, w, c)`` order before ``f1_w``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.common import dense_init

_LOG_2PI = math.log(2 * math.pi)


def _conv_same(x, w, b):
    """x: (B, C, H, W); w: HWIO 3x3 -> (B, Cout, H, W), SAME padding."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), b, padding=1)


def init_net(gen: torch.Generator, state_shape, action_dim: int,
             device="cuda") -> dict:
    """Random parameters on ``device``, drawn from ``gen`` on the
    generator's own device (so one seed gives the same numbers on the CPU
    and the card) with the reference's scales; ``std_b`` is 0.5, every
    other bias zero."""
    dev = resolve_device(device)
    h, w = state_shape
    feat = 32 * h * w

    def dense(shape, scale=None):
        return dense_init(gen, shape, gen.device, scale=scale).to(dev)

    z = lambda n: torch.zeros((n,), dtype=torch.float32, device=dev)
    return {
        "c1_w": dense((3, 3, 1, 16), scale=0.3),
        "c1_b": z(16),
        "c2_w": dense((3, 3, 16, 32), scale=0.1),
        "c2_b": z(32),
        "f1_w": dense((feat, 128)),
        "f1_b": z(128),
        "f2_w": dense((128, 64)),
        "f2_b": z(64),
        # actor: mean + raw-std per action (2 outputs per action, 3.3)
        "mu_w": dense((64, action_dim), scale=0.01),
        "mu_b": z(action_dim),
        "std_w": dense((64, action_dim), scale=0.01),
        "std_b": torch.full((action_dim,), 0.5, device=dev),
        "v_w": dense((64, 1), scale=0.1),
        "v_b": z(1),
    }


def features(params: dict, s):
    """s: (B, H, W) -> (B, 64)."""
    x = s[:, None]
    x = F.relu(_conv_same(x, params["c1_w"], params["c1_b"]))
    x = F.relu(_conv_same(x, params["c2_w"], params["c2_b"]))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["f1_w"] + params["f1_b"])
    return F.relu(x @ params["f2_w"] + params["f2_b"])


def actor_critic(params: dict, s):
    """Returns (mu (B, A), std (B, A), value (B,))."""
    f = features(params, s)
    mu = f @ params["mu_w"] + params["mu_b"]
    std = F.softplus(f @ params["std_w"] + params["std_b"]) + 1e-3
    v = (f @ params["v_w"] + params["v_b"])[:, 0]
    return mu, std, v


def gaussian_logp(mu, std, a):
    z = (a - mu) / std
    return torch.sum(-0.5 * z * z - torch.log(std) - 0.5 * _LOG_2PI,
                     dim=-1)
