"""The paper's validation loops as CUDA kernels with a loop-body noise slot."""
