"""Training: the step (``step.py``) and the loop (``loop.py``)."""
