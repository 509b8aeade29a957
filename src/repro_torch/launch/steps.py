"""Step builders for the dry-run: for every (arch x shape x mesh) cell, the
per-rank program of rank 0 (``fn``), its arguments and their specs, so
that running ``fn(*args)`` on meta tensors under ``roofline.OpTrace``
exercises the whole production program (the train step: loss, gradients
and AdamW; the forward for prefill; one token against a ``seq_len``
cache for decode) without allocating anything.

PyTorch port of the reference's ``repro.launch.steps``. The reference
builds abstract values (``jax.eval_shape``, ``ShapeDtypeStruct``) and
hands GSPMD the global program with ``NamedSharding``s; the port has no
GSPMD, so its programs are explicit per-rank ones (``train/trainer.py``,
``serve/mesh.py``): the state and cache are held as this rank's shards
and the weights gathered at use, ZeRO-3 style; for the transformer
family the leaves that the rules split over ``model`` (heads, ``ff``,
vocabulary, as far as they divide) are gathered over the other axes only
and each rank computes its own part of those layers (tensor
parallelism), as GSPMD splits the reference's program; the MoE's experts
and the ssm, hybrid and encdec families compute replicated over
``model``. ``args`` hold tensors: meta
tensors for the dry-run (``device="meta"``), or real ones on the card
(``chip_smoke.py`` runs the same ``fn`` there on a one-rank group).
``in_shardings`` hold the ``P`` trees that ``resolve_tree`` gives, as the
reference's hold ``NamedSharding``s: the state, params and cache as this
rank holds them, the batch as the program cuts it.

DRYRUN_TUNING is the reference's table as it is, because it defines the
cells' programs (microbatches bound activation memory; scan_group trades
recompute for saved residuals on the deepest models). Its values were
tuned for a TPU with 16 GiB of HBM a chip; the port's records say what
they cost on the H100 meshes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs import (SHAPES, TrainConfig, get_config,
                                 shape_applicable)
from repro_torch.configs.base import ShapeConfig
from repro_torch.models.model import ModelApi, build
from repro_torch.parallel import sharding as sh
from repro_torch.roofline.trace import tensor_bytes
from repro_torch.serve import mesh as serve_mesh
from repro_torch.train import trainer as tr

# (microbatches, scan_group) per arch for train_4k. Rationale: microbatch
# count M splits the 256-seq global batch into M accumulation steps; the
# per-chip saved residual is then ceil(B/M/dp)·S·D·2B per layer boundary.
DRYRUN_TUNING: dict[str, tuple[int, int]] = {
    "mixtral_8x22b": (16, 1),
    "qwen3_moe_30b_a3b": (8, 1),
    "mamba2_780m": (1, 1),
    "whisper_large_v3": (4, 1),
    "llava_next_34b": (16, 2),
    "minitron_4b": (8, 1),     # 256k vocab: bound the logits buffer
    "deepseek_coder_33b": (8, 2),
    "gemma_2b": (8, 1),        # 256k vocab

    "mistral_large_123b": (8, 2),
    "zamba2_1p2b": (1, 1),
}

# decode cache length: the shape's seq_len ("one new token with a KV
# cache of seq_len").


@dataclasses.dataclass
class CellProgram:
    fn: Callable
    args: tuple                 # tensors (meta for the dry-run)
    in_shardings: Any           # P trees
    out_shardings: Any          # or None
    donate: tuple = ()
    kind: str = "train"
    # the bytes this rank holds of ``args``: its state, params and cache
    # shards and its rows of the batch
    argument_bytes: int = 0
    # of those, the bytes the program updates in place (the donated state)
    alias_bytes: int = 0


def _empty_like_specs(specs: dict, device) -> dict:
    return {k: torch.empty(s.shape, dtype=s.dtype, device=device)
            for k, s in specs.items()}


def _batch(api: ModelApi, shape: ShapeConfig, device) -> dict:
    """The global batch: empty on meta, the model's dummy batch (seeded)
    elsewhere."""
    if torch.device(device).type == "meta":
        return _empty_like_specs(api.input_specs(shape), device)
    return api.dummy_batch(shape, device=device)


def _rows_bytes(batch: dict, specs: dict, mesh) -> int:
    """The bytes of this rank's rows of ``batch`` under ``specs``."""
    sizes = sh.mesh_axis_sizes(mesh)
    total = 0
    for k, x in batch.items():
        split = math.prod(sizes[a] for e in specs[k]
                          for a in sh.entry_axes(e))
        total += x.numel() // split * x.element_size()
    return total


def train_cell(api: ModelApi, shape: ShapeConfig, mesh,
               *, microbatches: int, scan_group: int,
               compress: str | None = None,
               remat: str = "nothing", device="meta") -> CellProgram:
    tcfg = TrainConfig(microbatches=microbatches, scan_group=scan_group,
                       remat=remat)
    step = tr.make_train_step(api, tcfg, mesh=mesh, compress=compress)
    state = tr.Trainer(api, tcfg, mesh=mesh, compress=compress,
                       device=device).init_state()
    batch = _batch(api, shape, device)
    state_sh = tr.state_shardings(api, mesh, state)
    mb = {k: v[: v.shape[0] // max(microbatches, 1)]
          for k, v in batch.items()}
    batch_sh = tr.batch_shardings(mesh, mb)
    state_bytes = tensor_bytes(state)
    return CellProgram(fn=step, args=(state, batch),
                       in_shardings=(state_sh, batch_sh),
                       out_shardings=(state_sh, None),
                       donate=(0,), kind="train",
                       argument_bytes=state_bytes + _rows_bytes(
                           batch, batch_sh, mesh),
                       alias_bytes=state_bytes)


def prefill_cell(api: ModelApi, shape: ShapeConfig, mesh,
                 device="meta") -> CellProgram:
    params = api.init(0, device)
    pspecs, shapes = tr.shard_params(api, params, mesh)
    layout = serve_mesh.param_layout(pspecs, shapes, mesh)
    batch = _batch(api, shape, device)
    batch.pop("labels", None)
    batch_sh = tr.batch_shardings(mesh, batch)
    fn = serve_mesh.make_mesh_prefill(api, mesh, layout)
    return CellProgram(fn=fn, args=(params, batch),
                       in_shardings=(pspecs, batch_sh),
                       out_shardings=None, kind="prefill",
                       argument_bytes=tensor_bytes(params) + _rows_bytes(
                           batch, batch_sh, mesh))


def decode_cell(api: ModelApi, shape: ShapeConfig, mesh,
                device="meta") -> CellProgram:
    B, S = shape.global_batch, shape.seq_len
    cfg = api.cfg
    params = api.init(0, device)
    if cfg.family == "encdec":
        frames = torch.zeros((B, cfg.enc_frames, cfg.d_model),
                             dtype=getattr(torch, cfg.compute_dtype),
                             device=device)
        cache = api.decode_init(params, {"frames": frames, "max_seq": S})
        del frames
    else:
        cache = api.decode_init(params, {"tokens": torch.zeros(
            (B, 1), dtype=torch.int32, device=device), "max_seq": S})
    pspecs, shapes = tr.shard_params(api, params, mesh)
    layout = serve_mesh.param_layout(pspecs, shapes, mesh)
    cache, cache_layout = serve_mesh.shard_cache(api, cache, mesh)
    tokens = torch.zeros((B, 1), dtype=torch.int32, device=device)
    pos = torch.full((), S - 1, dtype=torch.int32, device=device)
    tokens_sh = sh.resolve(("batch", None), (B, 1), mesh)
    cache_sh = serve_mesh._nest(cache_layout.specs)
    fn = serve_mesh.make_mesh_decode(api, mesh, layout, cache_layout)
    cache_bytes = tensor_bytes(cache)
    return CellProgram(
        fn=fn, args=(params, cache, tokens, pos),
        in_shardings=(pspecs, cache_sh, tokens_sh, sh.P()),
        out_shardings=(None, cache_sh), donate=(1,), kind="decode",
        argument_bytes=(tensor_bytes(params) + cache_bytes
                        + _rows_bytes({"tokens": tokens},
                                      {"tokens": tokens_sh}, mesh)
                        + pos.element_size()),
        alias_bytes=cache_bytes)


def build_cell(arch: str, shape_name: str, mesh, *,
               compress: str | None = None,
               overrides: dict | None = None,
               remat: str = "nothing", device="meta") -> CellProgram:
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        raise SkipCell(reason)
    api = build(cfg)
    if shape.kind == "train":
        m, g = DRYRUN_TUNING.get(arch, (1, 1))
        return train_cell(api, shape, mesh, microbatches=m, scan_group=g,
                          compress=compress, remat=remat, device=device)
    if shape.kind == "prefill":
        return prefill_cell(api, shape, mesh, device=device)
    return decode_cell(api, shape, mesh, device=device)


class SkipCell(Exception):
    pass
