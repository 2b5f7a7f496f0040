"""Data: the procedural token stream of ``synthetic.py``. The tokenizers,
text sources and the streaming pipeline arrive with the data slice."""
