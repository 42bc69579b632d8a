"""PyTorch/CUDA port of the Arena hierarchical-FL reproduction.

``repro_torch`` mirrors ``repro``'s module paths and public names, one
module at a time, so a reader finds each counterpart under the same
name. It imports ``torch`` and numpy and never ``jax``: it runs on a GPU
host that has no JAX installed.

Every entry point defaults to ``device="cuda"`` and raises where no
card is present (``repro_torch.device.resolve_device``); the CPU runs
only when a caller passes ``device="cpu"``, as the tests do. The two
hot-path kernels of the synchronous cloud round (``segment_agg`` for
Eqs. 1/2 and ``segment_broadcast`` for the edge->device resync) are
hand-written CUDA C++ for ``sm_90a`` under ``kernels/csrc/``; they are
compiled with ``nvcc`` at first use (``kernels/_build.py``).
"""
