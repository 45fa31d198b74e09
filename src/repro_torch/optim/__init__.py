"""The port's optimizer: AdamW with a cosine schedule and global-norm
clipping (``optim/adamw.py``), and FD top-k gradient compression over a
``"pod"`` mesh axis (``optim/compress.py``)."""
