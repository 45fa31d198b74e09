"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

  * ``merge`` — the score-list merge (replaces ``merge_pallas``);
  * ``sweep`` — level arrivals and the Appendix-A wait rule (replace
    ``arrivals_pallas`` / ``wait_pallas``);
  * ``topk`` — the local top-k of the device collectives (replaces
    ``topk_pallas``).

Nothing is built at import; ``_build`` compiles the CUDA sources at the
first launch on the card and keeps one launch counter per kernel.
"""
