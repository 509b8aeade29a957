"""Carry state across from the reference package.

A region's input tensors and its noise operand are its whole state.
``to_torch`` turns the reference's region arguments — numpy arrays, as
``np.asarray`` gives them from a JAX region's ``args`` tuple — into the
port's tensors, so both packages compute on identical inputs; ``carry_to_torch`` does the same for a loop-noise carry (a dict of
arrays and tuples of arrays, ``core.loopnoise``), and
``noise_state_to_torch`` for a graph-level noise mode's state
(``core.noise``: arrays, tuples of them, bf16 matrices and int32 scalars),
and ``lm_params_to_torch`` for a model's initialised param tree (the models
hold random weights from a seed; nothing is downloaded).
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


# the state keys of each graph-level mode (core/noise.py make_state)
NOISE_STATE_KEYS = {
    "fp_add32": ("c", "accs"), "mxu_fma128": ("m", "c"),
    "vmem_ld": ("buf", "accs"), "hbm_stream": ("buf", "acc"),
    "hbm_latency": ("table", "idx", "acc"), "ici_allreduce": ("v",),
    "ici_allgather": ("v",), "ici_a2a": ("v",),
}


def _array_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bf16: carry the bits
        bits = torch.from_numpy(np.array(a.view(np.int16), copy=True))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def noise_state_to_torch(name: str, state: dict, device="cpu") -> dict:
    """A reference graph-noise state of mode ``name`` (numpy arrays — bf16
    ones included — tuples of them, int32 scalars) -> the port's state on
    ``device``, so both packages apply the same noise to the same buffers
    (the chase table is carried over, not redrawn)."""
    keys = NOISE_STATE_KEYS[name]
    if tuple(state) != keys:
        raise ValueError(f"{name} state has keys {tuple(state)}; want {keys}")
    return {key: (tuple(_array_to_torch(v, device) for v in value)
                  if isinstance(value, (tuple, list))
                  else _array_to_torch(value, device))
            for key, value in state.items()}


def lm_params_to_torch(cfg, params, device="cpu"):
    """The reference's LM param tree (dense, moe or vlm; numpy arrays as
    ``np.asarray`` gives them, bf16 carried bit for bit) -> the port's
    ``transformer.LM`` on ``device``. The reference stacks layer params on a
    leading (L, ...) axis — the experts as (L, E, d, f) — and each slice
    becomes one layer module, taken layer by layer."""
    from repro_torch.models import attention as attn
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf

    def t(a):
        return _array_to_torch(a, device)

    emb = params["embed"]
    embed = L.Embedding(t(emb["table"]),
                        t(emb["head"]) if "head" in emb else None)
    lay = params["layers"]
    layers = []
    for i in range(cfg.n_layers):
        a = lay["attn"]
        if "moe" in lay:
            ffn = moe_mod.MoE(*(t(np.asarray(lay["moe"][w])[i])
                                for w in ("router", "w_gate", "w_up",
                                          "w_down")))
        else:
            ffn = L.MLP(*(t(np.asarray(lay["mlp"][w])[i])
                          for w in ("w_gate", "w_up", "w_down")))
        layers.append(tf.Layer(
            L.RMSNorm(t(np.asarray(lay["ln1"]["scale"])[i])),
            attn.Attention(*(t(np.asarray(a[w])[i])
                             for w in ("wq", "wk", "wv", "wo"))),
            L.RMSNorm(t(np.asarray(lay["ln2"]["scale"])[i])), ffn))
    return tf.LM(embed, layers, L.RMSNorm(t(params["final_norm"]["scale"])))
