"""Load the JAX package's parameters into the port.

The reference keeps parameters as dicts of arrays in the same layout the
port uses (conv weights HWIO, dense weights ``(in, out)``, sorted-key
leaf order, LLM layer leaves stacked over a leading ``n_layers`` axis),
so loading is a copy per leaf. Arrays arrive as numpy (the
tests pass ``np.asarray`` of JAX arrays); bf16 leaves, which numpy holds
as an extension dtype, are carried over exactly through f32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import flatbank
from repro_torch.device import resolve_device


def tensor_from_numpy(a, dev: torch.device) -> torch.Tensor:
    """One array -> tensor on ``dev`` (bf16 exactly, through f32)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def params_from_numpy(params: dict, device="cuda") -> dict:
    """dict[str, array] -> dict[str, tensor] on ``device``."""
    dev = resolve_device(device)
    return {k: tensor_from_numpy(v, dev) for k, v in params.items()}


def tree_from_numpy(params: dict, device="cuda") -> dict:
    """A nested dict of arrays (a JAX parameter tree such as
    ``repro.models.Model.init``'s, given as numpy) -> the same nested dict
    of tensors on ``device``, leaf for leaf (bf16 exactly)."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return tensor_from_numpy(t, dev)

    return conv(params)


def bank_from_numpy(bank: dict, device="cuda") -> dict:
    """A bank dict of (N, ...) arrays -> a port bank on ``device``: one
    contiguous (N, P) matrix with the leaves as views into it (when all
    leaves share one dtype)."""
    leaves = params_from_numpy(bank, device)
    spec = flatbank.bank_spec(leaves)
    return spec.unflatten(spec.flatten(leaves))
