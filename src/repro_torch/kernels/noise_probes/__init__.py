"""noise_probes kernel: CUDA wrapper (kernel.py) and plain PyTorch oracles (ref.py)."""
