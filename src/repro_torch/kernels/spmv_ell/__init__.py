"""spmv_ell kernel: CUDA wrapper (kernel.py) and plain PyTorch oracles (ref.py)."""
