"""Entry points of the port: single-device serving (``serve.py``)."""
