"""The port's optimizer: AdamW with a cosine schedule and global-norm
clipping (``optim/adamw.py``)."""
