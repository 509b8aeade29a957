"""Static noise audit over compiled SASS (the paper's §2.3 analogue).

Runs BEFORE any measurement: every planned (region, mode) pair is built at
two small static noise counts plus a clean build, each build's SASS is
censused into per-(opcode, loop depth, function) instruction counts, and
the k-scaling delta tells, instruction-accurately, whether the noise
payload survived ``nvcc`` and ``ptxas``, which resource it exercises, and
(when it died) which corruption class ate it.

  graph.py      def-use graph over parsed SASS; dependency-chain depth
  resources.py  opcode -> resource tagging; pressure vector; direction rule
  audit.py      census, corruption detectors, AuditReport, plan-level audit
  capture.py    the golden SASS fixtures, captured on the card
"""
from repro_torch.analysis.audit import (  # noqa: F401
    K_HI,
    K_LO,
    AuditError,
    AuditReport,
    audit_pair,
    audit_plan,
    audit_texts,
    compile_texts,
    sass_text,
    take_census,
)
from repro_torch.analysis.graph import chain_depth, defuse_edges  # noqa: F401
from repro_torch.analysis.resources import (  # noqa: F401
    BANDWIDTH_OPS,
    COMPUTE_OPS,
    TARGET_FAMILY,
    predict_direction,
    pressure_vector,
)
