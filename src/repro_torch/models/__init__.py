"""The paper's testbed CNNs in PyTorch (``model.py``)."""
