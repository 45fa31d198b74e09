"""Launchers of the port: ``python -m repro_torch.launch.serve overlay``
serves overlay top-k queries from warm engines on a CUDA device, and
``... serve decode`` runs the LM prefill + decode path with FD top-k
sampling; ``launch.mesh`` builds the decode's mesh of virtual peers."""
