"""Launchers of the port: ``python -m repro_torch.launch.serve overlay``
serves overlay top-k queries from warm engines on a CUDA device."""
