"""Hand-written CUDA kernels of the port (``csrc/``) and their wrappers.

  segment_agg       -- fused segment-weighted bank aggregation (Eqs. 1/2)
  segment_broadcast -- edge->device bank resync, written in the bank dtype
  flash_attention   -- GQA online-softmax attention (causal, window,
                       q_offset)
  wkv6              -- chunked RWKV6 recurrence from a zero state

Each kernel has a plain PyTorch version in ``ref.py``; ``ops.py`` holds
the public names. Sources are compiled at first use by ``_build.py``.
"""
