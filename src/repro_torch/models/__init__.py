"""Models of the port: the paper's testbed CNNs and the LLM serving
slice (``model.py``: ``Model``/``build_model``; ``transformer``,
``attention``, ``rwkv``, ``decode``, ``common``)."""
