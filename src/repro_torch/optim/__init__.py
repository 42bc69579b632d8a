"""Optimizers (SGD, momentum, Adam) on dicts of tensors."""
from repro_torch.optim.optimizers import adam, sgd, sgd_momentum  # noqa: F401
