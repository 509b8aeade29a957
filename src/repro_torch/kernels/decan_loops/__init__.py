"""The DECAN loops of the paper's Table 3 and Fig. 6 as CUDA kernels."""
