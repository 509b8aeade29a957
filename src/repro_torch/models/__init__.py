"""Models of the port (every family: dense, MoE, VLM, SSM, hybrid and
encoder-decoder): layers, attention, MoE, SSM, transformer, hybrid,
encdec, API."""
