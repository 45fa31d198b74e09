"""Launchers of the port: ``python -m repro_torch.launch.serve overlay``
serves overlay top-k queries from warm engines on a CUDA device,
``... serve decode`` runs the LM prefill + decode path with FD top-k
sampling, and ``python -m repro_torch.launch.train`` trains an LM with
AdamW and checkpoints; ``launch.mesh`` builds the decode's mesh of
virtual peers and the production mesh, and ``launch.ranks`` starts a
group of gloo ranks on one machine."""
