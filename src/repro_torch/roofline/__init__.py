"""The dry-run's roofline: the op trace of a per-rank program
(``trace``), its three terms (``terms``) and the table of every cell
(``report``)."""
from repro_torch.roofline.terms import (  # noqa: F401
    RooflineReport,
    analyze_trace,
    collective_wire_bytes,
    dot_flops,
    model_flops,
)
from repro_torch.roofline.trace import OpRecord, OpTrace  # noqa: F401
