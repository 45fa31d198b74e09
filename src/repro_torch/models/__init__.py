"""The LM stack of the port: the dense GQA decoder (layers, RoPE,
attention, blocks, the model API)."""
