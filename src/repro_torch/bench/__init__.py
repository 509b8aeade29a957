"""The paper's validation kernels as loop regions on the card, and the
drivers of its Fig. 7 (SPMXV) and Fig. 5 (STREAM, lat_mem_rd, HACCmk)
studies (``python -m repro_torch.bench {fig7,fig5}``)."""
from repro_torch.bench.kernels import (  # noqa: F401
    haccmk_region,
    lat_mem_rd_region,
    matmul_region,
    spmxv_region,
    stream_region,
)
