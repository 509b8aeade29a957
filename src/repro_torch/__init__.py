"""PyTorch/CUDA port of the noise-injection bottleneck tool (the JAX package
``repro`` is the reference). No module here imports jax or ``repro``."""
