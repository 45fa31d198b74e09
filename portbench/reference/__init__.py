"""Plain references of the benchmark's cells: plain PyTorch, importing
nothing of the program, of JAX or of the JAX package.  They make the
inputs (scores, weights) from the seed and work out for themselves what
the program derives from them."""
