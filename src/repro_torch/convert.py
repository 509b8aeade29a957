"""Carry state across from the reference package.

A region's input tensors and its noise operand are its whole state.
``to_torch`` turns the reference's region arguments — numpy arrays, as
``np.asarray`` gives them from a JAX region's ``args`` tuple — into the
port's tensors, so both packages compute on identical inputs; ``carry_to_torch`` does the same for a loop-noise carry (a dict of
arrays and tuples of arrays, ``core.loopnoise``), and
``noise_state_to_torch`` for a graph-level noise mode's state
(``core.noise``: arrays, tuples of them, bf16 matrices and int32 scalars),
and ``params_to_torch`` for a model's initialised param tree of any family
(the models hold random weights from a seed; nothing is downloaded), and
``train_state_to_torch`` for a training state (params, AdamW moments and
master copies, step), so both packages train from the same state.

The reference stacks every per-layer leaf on a leading (L, ...) axis
(``STACKED_TREES``); the port holds one module a layer, so a leaf's rank
there is one more than the port tensor's (``reference_ndim``).
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


# the param subtrees the reference stacks (L, ...), one slice a layer
STACKED_TREES = ("layers", "blocks", "mamba", "enc_layers", "dec_layers")


def reference_leaf(name: str) -> str:
    """The reference's leaf of the port's parameter ``name``: a stacked
    tree's layer index dropped (``layers.3.attn.wq`` and ``layers.0.attn.wq``
    are slices of the reference's one ``layers.attn.wq``)."""
    head, _, rest = name.partition(".")
    if head in STACKED_TREES:
        return f"{head}.{rest.partition('.')[2]}"
    return name


def reference_ndim(name: str, t: torch.Tensor) -> int:
    """The rank of the reference's leaf for the port's parameter ``name``
    (a ``named_parameters`` key): ``layers.3.ln1.scale`` (d,) is a slice of
    the reference's (L, d) leaf, ``final_norm.scale`` is (d,) in both."""
    return t.ndim + (name.split(".", 1)[0] in STACKED_TREES)


def _layer(tree, i: int, device) -> dict:
    """Slice i of every leaf of a stacked (L, ...) subtree, as tensors."""
    if isinstance(tree, dict):
        return {k: _layer(v, i, device) for k, v in tree.items()}
    return _array_to_torch(np.asarray(tree)[i], device)


def _tensors(tree, device) -> dict:
    """Every leaf of an unstacked subtree, as tensors."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return _array_to_torch(tree, device)


def _norm(tree):
    from repro_torch.models import layers as L
    return L.RMSNorm(tree["scale"])


def _attention(tree):
    from repro_torch.models import attention as attn
    return attn.Attention(*(tree[w] for w in ("wq", "wk", "wv", "wo")))


def _mlp(tree):
    from repro_torch.models import layers as L
    return L.MLP(*(tree[w] for w in ("w_gate", "w_up", "w_down")))


def _embedding(tree):
    from repro_torch.models import layers as L
    return L.Embedding(tree["table"], tree.get("head"))


def lm_params_to_torch(cfg, params, device="cpu"):
    """The reference's LM param tree (dense, moe or vlm; numpy arrays as
    ``np.asarray`` gives them, bf16 carried bit for bit) -> the port's
    ``transformer.LM`` on ``device``. The reference stacks layer params on a
    leading (L, ...) axis — the experts as (L, E, d, f) — and each slice
    becomes one layer module, taken layer by layer."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf

    layers = []
    for i in range(cfg.n_layers):
        lay = _layer(params["layers"], i, device)
        ffn = (moe_mod.MoE(*(lay["moe"][w] for w in ("router", "w_gate",
                                                      "w_up", "w_down")))
               if "moe" in lay else _mlp(lay["mlp"]))
        layers.append(tf.Layer(_norm(lay["ln1"]), _attention(lay["attn"]),
                               _norm(lay["ln2"]), ffn))
    return tf.LM(_embedding(_tensors(params["embed"], device)), layers,
                 _norm(_tensors(params["final_norm"], device)))


def ssm_params_to_torch(cfg, params, device="cpu"):
    """The reference's Mamba2 LM tree (``blocks`` stacked (L, ...)) -> the
    port's ``ssm.SSMLM``, one ``Block`` a layer."""
    from repro_torch.models import ssm

    blocks = []
    for i in range(cfg.n_layers):
        lay = _layer(params["blocks"], i, device)
        blocks.append(ssm.Block(_norm(lay["ln"]), ssm.SSM(**lay["ssm"])))
    return ssm.SSMLM(_embedding(_tensors(params["embed"], device)), blocks,
                     _norm(_tensors(params["final_norm"], device)))


def hybrid_params_to_torch(cfg, params, device="cpu"):
    """The reference's zamba2 tree (``mamba`` stacked (L, ...), one
    ``shared`` block) -> the port's ``hybrid.Hybrid``."""
    from repro_torch.models import hybrid
    from repro_torch.models import ssm

    mamba = []
    for i in range(cfg.n_layers):
        lay = _layer(params["mamba"], i, device)
        mamba.append(ssm.Block(_norm(lay["ln"]), ssm.SSM(**lay["ssm"])))
    sh = _tensors(params["shared"], device)
    shared = hybrid.Shared(_norm(sh["ln1"]), _attention(sh["attn"]),
                           _norm(sh["ln2"]), _mlp(sh["mlp"]))
    return hybrid.Hybrid(_embedding(_tensors(params["embed"], device)), mamba,
                         shared, _norm(_tensors(params["final_norm"], device)))


def encdec_params_to_torch(cfg, params, device="cpu"):
    """The reference's whisper tree (``enc_layers``, ``dec_layers`` stacked
    (L, ...)) -> the port's ``encdec.EncDec``."""
    from repro_torch.models import encdec

    enc, dec = [], []
    for i in range(cfg.enc_layers):
        lay = _layer(params["enc_layers"], i, device)
        enc.append(encdec.EncLayer(_norm(lay["ln1"]), _attention(lay["attn"]),
                                   _norm(lay["ln2"]), _mlp(lay["mlp"])))
    for i in range(cfg.n_layers):
        lay = _layer(params["dec_layers"], i, device)
        dec.append(encdec.DecLayer(
            _norm(lay["ln1"]), _attention(lay["attn"]), _norm(lay["lnx"]),
            _attention(lay["xattn"]), _norm(lay["ln2"]), _mlp(lay["mlp"])))
    return encdec.EncDec(_embedding(_tensors(params["embed"], device)), enc,
                         _norm(_tensors(params["enc_norm"], device)), dec,
                         _norm(_tensors(params["final_norm"], device)))


def params_to_torch(cfg, params, device="cpu"):
    """A reference param tree of ``cfg``'s family -> the port's module."""
    if cfg.family == "ssm":
        return ssm_params_to_torch(cfg, params, device)
    if cfg.family == "hybrid":
        return hybrid_params_to_torch(cfg, params, device)
    if cfg.family == "encdec":
        return encdec_params_to_torch(cfg, params, device)
    return lm_params_to_torch(cfg, params, device)


def named_to_torch(cfg, tree, device="cpu") -> dict:
    """A param-shaped reference tree -> {port parameter name: tensor}."""
    return {name: p.detach() for name, p in
            params_to_torch(cfg, tree, device).named_parameters()}


def train_state_to_torch(cfg, state, device="cpu"):
    """The reference's ``TrainState`` (numpy leaves: params, the AdamW
    ``mu``/``nu``/``master`` trees laid out as the params, the step, the
    compression residuals) -> the port's ``train.TrainState`` on
    ``device``, through ``params_to_torch``'s layout map."""
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.trainer import TrainState

    opt = state.opt
    step = torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                        device=device)
    return TrainState(
        params=params_to_torch(cfg, state.params, device),
        opt=AdamWState(step=step, mu=named_to_torch(cfg, opt.mu, device),
                       nu=named_to_torch(cfg, opt.nu, device),
                       master=(None if opt.master is None
                               else named_to_torch(cfg, opt.master, device))),
        residuals=(None if state.residuals is None
                   else named_to_torch(cfg, state.residuals, device)))
