"""Deterministic, resumable synthetic data pipeline.

PyTorch port of the reference's ``repro.data.pipeline``: the same
``np.random.RandomState`` draws in the same order, so a batch's tokens,
labels, frames and image embeds are bitwise the reference's. Batches are a
pure function of (seed, step): after a restart the pipeline replays
exactly the batch the failed step would have consumed (the trainer's
fault-tolerance contract). Tensors are made on the CPU and moved to
``device``.

Tasks:
  lcg      — t_{n+1} = (a·t_n + c) mod V: deterministic structure a small LM
             drives to near-zero loss.
  uniform  — i.i.d. tokens (throughput runs).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.layers import cdtype_of

_A, _C = 1103515245, 12345


@dataclasses.dataclass
class SyntheticPipeline:
    cfg: ModelConfig
    shape: ShapeConfig
    task: str = "lcg"
    seed: int = 0
    batch_override: Optional[int] = None
    device: Any = "cuda"

    def _rng(self, step: int) -> np.random.RandomState:
        return np.random.RandomState((self.seed * 1_000_003 + step) % (2**31))

    def batch(self, step: int) -> dict[str, torch.Tensor]:
        V = self.cfg.vocab_size
        B = self.batch_override or self.shape.global_batch
        S = self.shape.seq_len
        rng = self._rng(step)
        if self.task == "lcg":
            a = (_A % V) or 1
            t = rng.randint(0, V, size=(B, 1))
            seq = [t]
            for _ in range(S):
                t = (a * t + _C) % V
                seq.append(t)
            full = np.concatenate(seq, axis=1)           # (B, S+1)
            tokens, labels = full[:, :-1], full[:, 1:]
        else:
            tokens = rng.randint(0, V, size=(B, S))
            labels = np.roll(tokens, -1, axis=1)

        def put(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=self.device, dtype=dtype)

        out = {"tokens": put(tokens, torch.int32),
               "labels": put(labels, torch.int32)}
        if self.cfg.family == "encdec":
            out["frames"] = put(
                rng.standard_normal((B, self.cfg.enc_frames,
                                     self.cfg.d_model)).astype(np.float32),
                cdtype_of(self.cfg))
        if self.cfg.family == "vlm":
            out["img_embeds"] = put(
                rng.standard_normal((B, self.cfg.n_img_tokens,
                                     self.cfg.d_model)).astype(np.float32),
                cdtype_of(self.cfg))
        return out

    # iterator protocol (stateful cursor) — the trainer can also call
    # ``pipeline.batch(step)`` directly for exact replay.
    def __iter__(self):
        self._cursor = 0
        return self

    def __next__(self):
        b = self.batch(self._cursor)
        self._cursor += 1
        return b

    def __call__(self, step: int):
        return self.batch(step)
