"""PyTorch/CUDA port of the Arena hierarchical-FL reproduction.

``repro_torch`` mirrors ``repro``'s module paths and public names, one
module at a time, so a reader finds each counterpart under the same
name. It imports ``torch`` and numpy and never ``jax``: it runs on a GPU
host that has no JAX installed.

Every entry point defaults to ``device="cuda"`` and raises where no
card is present (``repro_torch.device.resolve_device``); the CPU runs
only when a caller passes ``device="cpu"``, as the tests do.

Two paths are ported. The synchronous cloud round of the HFL simulator
(``sim``, ``core``) runs its aggregation kernels ``segment_agg`` (Eqs.
1/2) and ``segment_broadcast`` (the edge->device resync). The LLM
serving path (``configs``, ``models``, ``launch.serve``: prefill, then
greedy one-token decode of the ``dense`` and ``ssm`` families, e.g.
qwen3-1.7b and rwkv6-1.6b) runs ``flash_attention`` for every attention
and ``wkv6`` for every multi-token RWKV6 time-mix. All four kernels are
hand-written CUDA C++ for ``sm_90a`` under ``kernels/csrc/``, compiled
with ``nvcc`` at first use (``kernels/_build.py``).
"""
