"""Batched serving engine: continuous batching over a paged KV-cache pool.

PyTorch port of the reference's ``repro.serve.engine``. Slots: a fixed
decode batch of ``n_slots`` sequences with per-slot positions. Requests
queue up; a finished slot is immediately refilled from the queue — decode
never stalls on stragglers of the batch.

Two cache layouts:

* **paged** (the default): one pool of fixed-size KV pages plus a per-slot
  int32 page table (``models/attention.py``). A whole admission wave
  prefills in ONE batched forward pass (``lm_paged_prefill``) scattered
  straight into pages; pages free on retire and are reused. Per-tick
  bookkeeping (``pos``, ``cur``, the active mask) lives on the device; each
  tick is one call of the tick program plus a single host sync that fetches
  the sampled tokens and positions.
* **dense** (``paged=False``, and the only layout of the ssm and hybrid
  families): the per-slot cache, every slot decoding at each tick with
  its own position. For the attention families (dense, moe, vlm) an
  admission wave prefills in the same batched, bucketed forward as the
  paged one's (the reference prefills one request at a time at its own
  length): the card's product kernels depend on the shapes, and the same
  batch keeps the two layouts' greedy tokens equal in bf16. For a MoE the
  same batch is also the same routing: an expert's capacity depends on
  the tokens of the call, padding rows included, so both layouts route the
  same rows at the same shapes (the decode tick routes every slot, inactive
  ones too, as the reference's does). The ssm and hybrid families prefill
  SEQUENTIALLY, as the reference's: each request alone, its prompt
  replayed one token at a time through ``decode_step`` on a fresh
  single-slot cache, which is then scattered into the batched cache along
  each leaf's declared batch axis (``cache_spec``'s "cache_batch").

Dense and paged layouts are numerically identical; tests pin it. The
programs run eagerly: PyTorch has no ``jit`` to call, and the probe's serve
regions capture them as CUDA graphs (``core/injector.py``). Caches are
written in place (``models/attention.py``); the prefill and tick programs
are idempotent on their arguments, so a snapshot (``probe_cells``) can be
re-run any number of times.

Sampling: greedy, or temperature with Gumbel noise from a
``torch.Generator`` seeded per call from the engine's host generator (the
reference splits a ``PRNGKey``; the draws differ, greedy decoding is what
the tests compare); a sequential prefill's first token is the argmax, as
the reference's. Refused, as the reference fails: the paged layout for
the ssm, hybrid and encdec families and for a sliding window (the
reference's ``ValueError``); a sliding-window config in the dense layout
(the reference's prefill pads the KV to ``max_seq`` where the batched
cache is a ring of ``window`` slots, and the first admission fails); and
the encdec family (the reference's engine calls ``decode_init`` without
``frames``: ``KeyError: 'frames'``). ROADMAP queue 3 holds both faults.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models import transformer as tf
from repro_torch.models.model import LM_FAMILIES, ModelApi

# the families whose dense layout prefills sequentially
SEQUENTIAL_FAMILIES = ("ssm", "hybrid")


ENCDEC_REFUSED = (
    "serving the encdec family is refused: the reference's engine calls "
    "decode_init(params, {'tokens', 'max_seq'}) without 'frames', and "
    "encdec_decode_init reads batch['frames'], so it fails with KeyError: "
    "'frames' (ROADMAP queue 3); serving audio is a feature the reference "
    "lacks")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new: int = 32
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _clone(obj):
    """A deep copy of a cache tree / argument (tensors cloned)."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    return obj


class ServeEngine:
    def __init__(self, api: ModelApi, params, *, n_slots: int = 4,
                 max_seq: int = 512, temperature: float = 0.0,
                 eos_id: Optional[int] = None, seed: int = 0,
                 paged: Optional[bool] = None, page_size: int = 16,
                 n_pages: Optional[int] = None):
        self.api = api
        self.cfg = api.cfg
        self.params = params
        self.device = next(params.parameters()).device
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.temperature = temperature
        self.eos_id = eos_id
        self._gen = torch.Generator().manual_seed(seed)
        self._key = 0
        self.queue: deque[Request] = deque()
        self.slot_req: list[Optional[Request]] = [None] * n_slots
        self._next_uid = 1000            # monotonic: uids never reused
        self._completed: list[Request] = []
        self.stats: dict[str, Any] = {
            "prefill_tokens": 0, "decode_tokens": 0, "prefill_calls": 0,
            "ticks": 0, "wall_s": 0.0, "occupancy_sum": 0.0,
            "occupancy_n": 0}

        pageable = self.cfg.family in LM_FAMILIES and not self.cfg.window
        if paged and not pageable:
            raise ValueError(
                f"paged serving needs an attention KV cache without a "
                f"sliding window (family={self.cfg.family!r}, "
                f"window={self.cfg.window})")
        if self.cfg.family == "encdec":
            raise NotImplementedError(ENCDEC_REFUSED)
        if self.cfg.window:
            raise NotImplementedError(
                f"serving a sliding-window config (window={self.cfg.window}) "
                "is refused: the reference's dense layout cannot serve it "
                "(its lm_prefill pads the KV to max_seq while init_cache "
                "makes a ring of window slots, and the first admission "
                "fails on the shapes; ROADMAP queue 3)")
        self.paged = pageable if paged is None else paged
        self._sequential = self.cfg.family in SEQUENTIAL_FAMILIES

        dev = self.device
        self.pos = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self.cur = torch.zeros((n_slots, 1), dtype=torch.int32, device=dev)
        self.active = np.zeros((n_slots,), bool)
        self._active_dev = torch.as_tensor(self.active, device=dev)

        self.page_size = page_size       # the prefill buckets' unit
        if self.paged:
            if max_seq % page_size:
                raise ValueError(f"max_seq={max_seq} must be a multiple of "
                                 f"page_size={page_size}")
            self.max_pages = max_seq // page_size
            self.n_pages = (n_slots * self.max_pages if n_pages is None
                            else n_pages)
            if self.n_pages < self.max_pages:
                raise ValueError("page pool smaller than one request's "
                                 f"worst case ({self.max_pages} pages)")
            self._trash = self.n_pages   # pool page P: scatter sink, never read
            self.cache = tf.lm_paged_decode_init(
                params, self.cfg, self.n_pages + 1, page_size, dev)
            self._table_np = np.full((n_slots, self.max_pages), self._trash,
                                     np.int32)
            self.page_table = torch.as_tensor(self._table_np, device=dev)
            self._free: list[int] = list(range(self.n_pages))
            self._slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
            self._stalled = np.zeros((n_slots,), bool)
            self._prefill_raw, self._tick_raw = _make_paged_fns(
                self.cfg, temperature)
            self._last_wave = None
        else:
            self.cache = api.decode_init(params, {
                "tokens": torch.zeros((n_slots, 1), dtype=torch.int32),
                "max_seq": max_seq})

    # ------------------------------------------------------------------
    def submit(self, prompt: list[int], *, max_new: int = 32) -> Request:
        prompt = list(prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.max_seq - 1:
            raise ValueError(f"prompt length {len(prompt)} exceeds "
                             f"max_seq-1={self.max_seq - 1}")
        req = Request(uid=self._next_uid, prompt=prompt, max_new=max_new)
        self._next_uid += 1
        self.queue.append(req)
        return req

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- paged path ----------------------------------------------------
    def _bucket(self, sp: int) -> int:
        """Pad a prompt length to a power-of-two multiple of the page size
        (capped at max_seq) — bounds the number of prefill shapes."""
        n = self.page_size
        while n < sp:
            n *= 2
        return min(n, self.max_seq)

    def _set_active(self, slot: int, value: bool) -> None:
        self.active[slot] = value
        self._active_dev = self._to_dev(self.active)

    def _next_key(self) -> int:
        """The sampling seed of the next program call (0 when greedy)."""
        if self.temperature > 0:
            self._key = int(torch.randint(0, 2 ** 62, (1,),
                                          generator=self._gen))
        return self._key

    def _resume_stalled(self) -> None:
        """Re-activate slots that stalled on an empty free list once pages
        are available again (their pages, pos and cur are intact, so
        generation just continues)."""
        resumed = False
        for slot in range(self.n_slots):
            if not self._stalled[slot]:
                continue
            if not self._free:
                break       # NOT return: already-resumed slots need the sync
            pp = len(self._slot_pages[slot])
            pid = self._free.pop()
            self._slot_pages[slot].append(pid)
            self._table_np[slot, pp] = pid
            self._stalled[slot] = False
            self._set_active(slot, True)
            resumed = True
        if resumed:
            self.page_table = self._to_dev(self._table_np)

    def _admit_wave(self) -> bool:
        """Admit up to ``n_slots`` queued requests in ONE batched prefill:
        pad the wave's prompts to a common bucketed length, (paged) allocate
        the covering pages per member, run the prefill once, and sample each
        member's first token. Both layouts admit this way, so they compute
        the same rows at the same shapes (see ``_dense_prefill``)."""
        free_slots = [s for s in range(self.n_slots)
                      if self.slot_req[s] is None]
        wave: list[tuple[int, Request]] = []
        while free_slots and self.queue:
            if self.paged:
                cand = [r for _, r in wave] + [self.queue[0]]
                spad = self._bucket(max(len(r.prompt) for r in cand))
                if (spad // self.page_size) * len(cand) > len(self._free):
                    break
            wave.append((free_slots.pop(0), self.queue.popleft()))
        if not wave:
            return False

        spad = self._bucket(max(len(r.prompt) for _, r in wave))
        toks = np.zeros((self.n_slots, spad), np.int32)
        lens = np.ones((self.n_slots,), np.int32)
        adm = np.zeros((self.n_slots,), bool)
        for slot, req in wave:
            toks[slot, :len(req.prompt)] = req.prompt
            lens[slot] = len(req.prompt)
            adm[slot] = True
        if self.paged:
            npp = spad // self.page_size
            rows = np.full((self.n_slots, npp), self._trash, np.int32)
            for slot, _ in wave:
                pages = [self._free.pop() for _ in range(npp)]
                self._slot_pages[slot] = pages
                self._table_np[slot, :] = self._trash
                self._table_np[slot, :npp] = pages
                rows[slot] = pages
            self.page_table = self._to_dev(self._table_np)
            wave_args = tuple(self._to_dev(a)
                              for a in (toks, rows, lens, adm))
            self._last_wave = wave_args
            self.cache, self.pos, self.cur, nxt = self._prefill_raw(
                self.params, self.cache, *wave_args, self.pos, self.cur,
                self._next_key())
        else:
            self.cache, self.pos, self.cur, nxt = _dense_prefill(
                self.params, self.cfg, self.temperature, self.cache,
                *(self._to_dev(a) for a in (toks, lens, adm)),
                [slot for slot, _ in wave], self.pos, self.cur,
                self._next_key())
        nxt_h = nxt.cpu().numpy()
        for slot, req in wave:
            req.out.append(int(nxt_h[slot]))
            self.slot_req[slot] = req
            self._set_active(slot, True)
            self.stats["prefill_tokens"] += len(req.prompt)
        self.stats["prefill_calls"] += 1
        return True

    def _step_paged(self) -> None:
        self._resume_stalled()
        self._admit_wave()
        if not self.active.any():
            if any(r is not None for r in self.slot_req):
                raise RuntimeError(
                    "page pool exhausted: every in-flight request is "
                    "stalled and nothing can retire — size the pool at "
                    "n_slots * (max_seq // page_size) pages to rule this "
                    "out")
            return
        self.cache, self.cur, self.pos, nxt = self._tick_raw(
            self.params, self.cache, self.cur, self.pos, self._active_dev,
            self.page_table, self._next_key())
        # the tick's single host sync: sampled tokens + updated positions
        both = torch.stack((nxt, self.pos)).cpu().numpy()
        nxt_h, pos_h = both[0], both[1]
        self.stats["ticks"] += 1
        self.stats["decode_tokens"] += int(self.active.sum())
        self.stats["occupancy_sum"] += self.pool_occupancy()
        self.stats["occupancy_n"] += 1
        table_dirty = False
        for slot in range(self.n_slots):
            req = self.slot_req[slot]
            if req is None or not self.active[slot]:
                continue
            tok = int(nxt_h[slot])
            req.out.append(tok)
            if ((self.eos_id is not None and tok == self.eos_id)
                    or len(req.out) >= req.max_new
                    or int(pos_h[slot]) >= self.max_seq - 1):
                self._retire(slot)
                table_dirty = True
                continue
            pp = int(pos_h[slot]) // self.page_size   # next write position
            if pp >= len(self._slot_pages[slot]):
                if self._free:
                    pid = self._free.pop()
                    self._slot_pages[slot].append(pid)
                    self._table_np[slot, pp] = pid
                    table_dirty = True
                else:
                    self._stalled[slot] = True
                    self._set_active(slot, False)
        if table_dirty:
            self.page_table = self._to_dev(self._table_np)

    def pool_occupancy(self) -> float:
        """Fraction of the page pool currently assigned to slots (paged);
        fraction of cache slots active (dense)."""
        if self.paged:
            return 1.0 - len(self._free) / self.n_pages
        return float(self.active.mean())

    # -- dense path ----------------------------------------------------
    def _scatter_slot(self, big: dict, small: dict, spec: dict,
                      slot: int) -> None:
        """Copy a single-request cache into ``slot`` of the batched cache
        along each leaf's DECLARED batch axis (``cache_spec``'s
        "cache_batch"), in place; a leaf without one (a ring cache's shared
        ``kpos``) is left alone, as the reference's ``_scatter_slot``."""
        for name, axes in spec.items():
            if isinstance(axes, dict):
                self._scatter_slot(big[name], small[name], axes, slot)
            elif "cache_batch" in axes:
                ax = axes.index("cache_batch")
                big[name].select(ax, slot).copy_(small[name].select(ax, 0))

    def _admit(self, slot: int, req: Request) -> None:
        """Sequential prefill of ``req`` into ``slot`` (ssm, hybrid): the
        prompt replayed through ``decode_step`` one token at a time on a
        fresh single-slot cache, then scattered into the batched one."""
        dev = self.device
        prompt = torch.tensor(req.prompt, dtype=torch.int32,
                              device=dev)[None, :]              # (1, Sp)
        sp = prompt.shape[1]
        c1 = self.api.decode_init(self.params, {"tokens": prompt[:, :1],
                                                "max_seq": self.max_seq})
        for i in range(sp):
            logits, c1 = self.api.decode_step(
                self.params, c1, prompt[:, i:i + 1],
                torch.tensor(i, dtype=torch.int32, device=dev))
        self._scatter_slot(self.cache, c1, self.api.cache_spec(), slot)
        next_tok = torch.argmax(logits[0, -1]).to(torch.int32)
        self.pos[slot] = sp
        self.cur[slot, 0] = next_tok
        req.out.append(int(next_tok))
        self._set_active(slot, True)
        self.slot_req[slot] = req
        self.stats["prefill_tokens"] += sp
        self.stats["prefill_calls"] += 1

    def _step_dense(self) -> None:
        if self._sequential:
            for slot in range(self.n_slots):
                if not self.active[slot] and self.queue:
                    self._admit(slot, self.queue.popleft())
        else:
            self._admit_wave()
        if not self.active.any():
            return
        logits, self.cache = self.api.decode_step(self.params, self.cache,
                                                  self.cur, self.pos)
        nxt = _sample(logits[:, -1, :], self.temperature, self._next_key())
        self.pos = self.pos + self._active_dev.to(torch.int32)
        self.cur = nxt[:, None]
        self.stats["ticks"] += 1
        self.stats["decode_tokens"] += int(self.active.sum())
        both = torch.stack((nxt, self.pos)).cpu().numpy()
        for slot in range(self.n_slots):
            req = self.slot_req[slot]
            if req is None:
                continue
            tok = int(both[0, slot])
            req.out.append(tok)
            if ((self.eos_id is not None and tok == self.eos_id)
                    or len(req.out) >= req.max_new
                    or int(both[1, slot]) >= self.max_seq - 1):
                self._retire(slot)

    # ------------------------------------------------------------------
    def _retire(self, slot: int) -> None:
        req = self.slot_req[slot]
        if req is not None:
            req.done = True
            self._completed.append(req)
        self.slot_req[slot] = None
        self._set_active(slot, False)
        if self.paged:
            self._free.extend(self._slot_pages[slot])
            self._slot_pages[slot] = []
            self._table_np[slot, :] = self._trash
            self._stalled[slot] = False

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One engine tick: admit into free slots, then one decode step."""
        if self.paged:
            self._step_paged()
        else:
            self._step_dense()

    def run(self, *, max_ticks: int = 1000) -> list[Request]:
        """Tick until the queue drains; returns every request completed
        since the last ``run`` call (manual ``step()`` completions and late
        submissions included)."""
        t0 = time.perf_counter()
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.step()
        self.stats["wall_s"] += time.perf_counter() - t0
        done, self._completed = self._completed, []
        return done

    def report(self) -> dict:
        """Throughput / occupancy summary over the ``run`` calls so far."""
        s = self.stats
        wall = s["wall_s"] or 1e-9
        occ = (s["occupancy_sum"] / s["occupancy_n"]
               if s["occupancy_n"] else self.pool_occupancy())
        return {"paged": self.paged,
                "decode_tok_s": s["decode_tokens"] / wall,
                "total_tok_s": (s["decode_tokens"] + s["prefill_tokens"])
                / wall,
                "prefill_tokens": s["prefill_tokens"],
                "decode_tokens": s["decode_tokens"],
                "prefill_calls": s["prefill_calls"],
                "ticks": s["ticks"], "wall_s": s["wall_s"],
                "mean_pool_occupancy": occ}

    # -- probe integration ---------------------------------------------
    def probe_cells(self):
        """Snapshot the engine's prefill and decode tick as re-runnable
        cells: ``(prefill_fn, prefill_args, tick_fn, tick_args)``. Each cell
        gets its own copy of the cache and of the bookkeeping tensors: the
        programs write the cache in place, and the prefill's padding would
        otherwise overwrite positions the tick reads. Re-running a cell
        recomputes the same state transition, so sweeps can time it any
        number of times."""
        if not self.paged:
            raise RuntimeError("probe_cells needs the paged engine")
        if self._last_wave is None:
            raise RuntimeError("admit at least one wave before probing")
        pf_args = (self.params, _clone(self.cache),
                   *(_clone(a) for a in self._last_wave), _clone(self.pos),
                   _clone(self.cur), self._key)
        tk_args = (self.params, _clone(self.cache), _clone(self.cur),
                   _clone(self.pos), _clone(self._active_dev),
                   _clone(self.page_table), self._key)
        return self._prefill_raw, pf_args, self._tick_raw, tk_args


def _sample(logits: torch.Tensor, temperature: float, key: int):
    """Greedy argmax, or a draw at ``temperature`` (Gumbel-max with noise
    from a generator seeded with ``key`` on the logits' device)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    gen = torch.Generator(device=logits.device).manual_seed(key)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits.float() / temperature + gumbel,
                        dim=-1).to(torch.int32)


def _dense_prefill(p, cfg, temperature, cache, toks, lens, adm, slots, pos,
                   cur, key):
    """The dense layout's wave prefill: the paged prefill's forward on the
    same (n_slots, bucket) batch, its KV written into the admitted slots'
    cache rows. The reference prefills one request at a time at its own
    length; on the card the products' kernels (and so their bf16 roundings)
    depend on the shapes, and the same batch is what keeps the two layouts'
    tokens equal. -> (cache, pos, cur, next_tokens)"""
    logits, _aux, kv = tf.lm_forward(p, cfg, {"tokens": toks},
                                     return_cache=True)
    rows = torch.tensor(slots, device=toks.device)
    sp = toks.shape[1]
    for name in ("k", "v"):
        cache["kv"][name][:, rows, :, :sp] = kv[name][:, rows]
    idx = (lens.long() - 1)[:, None, None].expand(-1, 1, logits.shape[-1])
    nxt = _sample(torch.gather(logits, 1, idx)[:, 0], temperature, key)
    pos = torch.where(adm, lens, pos)
    cur = torch.where(adm[:, None], nxt[:, None], cur)
    return cache, pos, cur, nxt


def _make_paged_fns(cfg, temperature: float):
    """The paged engine's two device programs.

    prefill(params, cache, toks, rows, lens, adm, pos, cur, key)
        -> (cache, pos, cur, next_tokens)
    tick(params, cache, cur, pos, active, table, key)
        -> (cache, cur, pos, next_tokens)

    The cache is written in place and returned; ``pos`` and ``cur`` come
    back as new tensors (the inputs are left alone, so a call is
    idempotent on its arguments).
    """
    def prefill(p, cache, toks, rows, lens, adm, pos, cur, key):
        logits, cache = tf.lm_paged_prefill(p, cfg, {"tokens": toks}, cache,
                                            rows)
        idx = (lens.long() - 1)[:, None, None].expand(-1, 1, logits.shape[-1])
        last = torch.gather(logits, 1, idx)[:, 0]                # (B, V)
        nxt = _sample(last, temperature, key)
        pos = torch.where(adm, lens, pos)
        cur = torch.where(adm[:, None], nxt[:, None], cur)
        return cache, pos, cur, nxt

    def tick(p, cache, cur, pos, active, table, key):
        logits, cache = tf.lm_paged_decode_step(p, cfg, cache, cur, pos,
                                                table)
        nxt = _sample(logits[:, -1, :], temperature, key)
        pos = pos + active.to(torch.int32)
        cur = torch.where(active[:, None], nxt[:, None], cur)
        return cache, cur, pos, nxt

    return prefill, tick
