"""Resource tagging for surviving noise instructions, over SASS.

Maps SASS opcodes (without modifiers) to the resource they exercise and
turns a census delta (extra instructions per injected pattern) into a
resource-pressure vector plus a predicted sensitivity direction: the
static half of the paper's claim that each noise mode pressures ONE
resource. The reference's families, read on the H100:

  compute    FP32, FP16 and FP64 arithmetic, the tensor cores (HMMA for
             ``mma.sync``, HGMMA for ``wgmma``) and the special-function
             unit (MUFU); counted per pattern
  bandwidth  loads from device memory, shared memory and the bulk/TMA
             copies; bytes a thread moves per pattern, from the width
             modifier (``.64``, ``.128``, ``.U8``, ...)
  latency    serial def-use chain growth through the load family (chain
             depth delta per pattern)
  ici        empty: a kernel of the port issues no interconnect
             instruction (the ICI noise modes' collectives are NCCL's
             kernels over the mesh's process group, ``core/noise.py``, and
             their SASS is not censused)

The direction rule is the reference's: any load-family payload dominates
the direction, and a load chain that grows as fast as the patterns is a
pointer chase, which pressures latency, not bandwidth.
"""
from __future__ import annotations

COMPUTE_OPS = frozenset({
    "FADD", "FFMA", "FMUL", "FMNMX", "FSWZADD", "DADD", "DFMA", "DMUL",
    "HADD2", "HFMA2", "HMUL2", "HMMA", "HGMMA", "IMMA", "IGMMA", "MUFU",
})
BANDWIDTH_OPS = frozenset({
    "LDG", "LDS", "LDSM", "LD", "LDGSTS", "UBLKCP", "UTMALDG",
})
ICI_OPS: frozenset = frozenset()

# a load chain growing at >= this fraction of a link PER PATTERN is serial
SERIAL_CHAIN_FRAC = 0.75

# noise-mode target vocabulary -> resource family the audit predicts
TARGET_FAMILY = {
    "compute": "compute",
    "vmem": "bandwidth",
    "l1": "bandwidth",
    "memory": "bandwidth",
    "latency": "latency",
    "ici": "ici",
}

_WIDTH_BYTES = {"U8": 1, "S8": 1, "U16": 2, "S16": 2, "32": 4, "64": 8,
                "128": 16}


def access_bytes(opcode: str) -> int:
    """Bytes one thread moves with a load-family ``opcode`` (its width
    modifier; 4 without one). ``LDSM.*.4`` loads four 32-bit registers."""
    parts = opcode.split(".")
    if parts[0] == "LDSM":
        return 4 * (int(parts[-1]) if parts[-1].isdigit() else 1)
    for mod in reversed(parts[1:]):
        if mod in _WIDTH_BYTES:
            return _WIDTH_BYTES[mod]
    return 4


def pressure_vector(count_delta: dict, bytes_delta: dict,
                    depth_delta: int, patterns: int) -> dict[str, float]:
    """Per-pattern resource pressure from a two-build census delta.

    ``count_delta``/``bytes_delta`` map (opcode, loop depth, where) ->
    extra instructions / extra bytes a thread moves. The depth places an
    instruction; it does not weight it (SASS says where code runs, not how
    often). ``depth_delta`` is the load-family chain-depth growth."""
    compute = sum(n for key, n in count_delta.items()
                  if key[0] in COMPUTE_OPS)
    bandwidth = sum(n for key, n in bytes_delta.items()
                    if key[0] in BANDWIDTH_OPS)
    ici = sum(n for key, n in count_delta.items() if key[0] in ICI_OPS)
    return {
        "compute": max(0.0, compute / patterns),
        "bandwidth": max(0.0, bandwidth / patterns),
        "latency": max(0.0, depth_delta / patterns),
        "ici": max(0.0, ici / patterns),
    }


def predict_direction(count_delta: dict, depth_delta: int,
                      patterns: int) -> str:
    """Which resource the surviving noise pressures most.

    Precedence: ici > load family > arithmetic; within the load family a
    chain whose depth grows ~one link per injected pattern is serial — a
    pointer chase — and predicts latency."""
    ici = sum(n for key, n in count_delta.items()
              if key[0] in ICI_OPS and n > 0)
    loads = sum(n for key, n in count_delta.items()
                if key[0] in BANDWIDTH_OPS and n > 0)
    arith = sum(n for key, n in count_delta.items()
                if key[0] in COMPUTE_OPS and n > 0)
    if ici > 0:
        return "ici"
    if loads > 0:
        if depth_delta >= SERIAL_CHAIN_FRAC * patterns:
            return "latency"
        return "bandwidth"
    if arith > 0:
        return "compute"
    return "none"
