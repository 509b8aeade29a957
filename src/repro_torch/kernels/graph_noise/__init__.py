"""The graph-level noise modes as CUDA kernels, one launch a call."""
