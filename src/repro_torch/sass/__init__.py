"""SASS text: ``cuobjdump -sass`` output parsed into functions and
instructions (the payload half of the reference's ``repro.hlo``).

  parse.py   functions, instructions (guard, opcode, registers, branch
             targets) and each instruction's loop depth
"""
from repro_torch.sass.parse import (Function, Instr, base_name,  # noqa: F401
                                    parse_sass)
