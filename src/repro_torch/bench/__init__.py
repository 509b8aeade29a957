"""The paper's validation kernels as loop regions on the card, its DECAN
loops, and the drivers of its studies (``python -m repro_torch.bench
{fig7,fig5,fig4,table3,fig6,table1,table4}``)."""
from repro_torch.bench.kernels import (  # noqa: F401
    haccmk_region,
    lat_mem_rd_region,
    livermore_target,
    matmul_region,
    spmxv_region,
    stream_region,
    table3_target,
)
