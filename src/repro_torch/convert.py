"""Carry state across from the reference package.

This system holds no weights: a region's input tensors and its noise operand
are its whole state. ``to_torch`` turns the reference's region arguments —
numpy arrays, as ``np.asarray`` gives them from a JAX region's ``args``
tuple — into the port's tensors, so both packages compute on identical
inputs; ``carry_to_torch`` does the same for a loop-noise carry (a dict of
arrays and tuples of arrays, ``core.loopnoise``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def to_torch(arrays: Sequence, device="cpu") -> tuple:
    """numpy arrays -> contiguous tensors on ``device``, dtypes kept (int32
    column indices stay int32)."""
    return tuple(torch.from_numpy(np.array(a, copy=True, order="C"))
                 .to(device) for a in arrays)


def carry_to_torch(carry: dict, device="cpu") -> dict:
    """A reference loop-noise carry (numpy arrays, tuples of them) -> the
    port's carry dict on ``device``."""
    out = {}
    for key, value in carry.items():
        if isinstance(value, (tuple, list)):
            out[key] = to_torch(value, device)
        else:
            out[key] = to_torch((value,), device)[0]
    return out
