"""Checkpoints of the port's training state (``ckpt/checkpoint.py``)."""
