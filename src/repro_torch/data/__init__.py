"""Data: the procedural token and vision streams of ``synthetic.py``. The
tokenizers, text sources and the streaming pipeline arrive with the data
slice."""
