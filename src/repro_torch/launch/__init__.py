"""Entry points of the port: single-device serving (``serve.py``) and
the bank mesh over ``torch.distributed`` (``mesh.py``)."""
