"""Arena core in PyTorch: the flat bank, the HFL round, PCA state,
reward and the profiling module."""
