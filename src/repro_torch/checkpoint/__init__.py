"""Checkpoints: pytree npz files and async-runtime crash recovery; the
port of ``repro.checkpoint``."""
from repro_torch.checkpoint.store import load_pytree, save_pytree  # noqa: F401
