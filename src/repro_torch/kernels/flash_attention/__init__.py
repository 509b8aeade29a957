"""flash_attention kernel: CUDA wrapper and plain version (kernel.py) and
the full-materialization oracle and the kernel's per-row tolerance
(ref.py)."""
