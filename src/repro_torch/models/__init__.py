"""Models of the port (the dense, MoE and VLM families): layers, attention,
MoE, transformer, API."""
