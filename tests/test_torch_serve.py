"""The port's serving engine (``repro_torch.serve``) on the CPU at smoke size:
the scenarios of the reference's ``tests/test_paged_serve.py`` and
``tests/test_serve_and_sharding.py``, and the port against the reference
engine on the same weights (``convert.lm_params_to_torch``):

* dense and paged decode logits agree in f32 (atol = rtol = 1e-5: the same
  computation re-laid-out); greedy tokens equal across layouts in bf16;
* refilled slots, EOS, max_new / max_seq retirement, page free and reuse,
  stall and resume (a partial resume syncs the device table), pool
  exhaustion and an undersized pool, monotonic uids, late completions;
* greedy tokens equal to the reference engine's, paged and dense, in f32;
* a snapshotted tick or prefill (``probe_cells``) called twice gives
  bit-identical outputs and leaves its cache as after the first call;
* the load harness's request streams and the serve region names are the
  reference's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.convert import lm_params_to_torch
from repro_torch.models import transformer as tf
from repro_torch.models.model import build
from repro_torch.serve import ServeEngine

ARCH = "deepseek_coder_33b"


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


@pytest.fixture(scope="module")
def smoke():
    api = build(configs.get_smoke_config(ARCH))
    return api, api.init(0, "cpu")


@pytest.fixture(scope="module")
def smoke_f32():
    api = build(_f32(configs.get_smoke_config(ARCH)))
    return api, api.init(0, "cpu")


def _prompts(n, rng=None, lo=2, hi=10):
    rng = rng or np.random.default_rng(7)
    return [rng.integers(1, 64, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


# ---------------------------------------------------------------------------
# dense vs paged
# ---------------------------------------------------------------------------

def test_paged_decode_logits_match_dense_f32(smoke_f32):
    api, params = smoke_f32
    cfg = api.cfg
    page, max_seq = 4, 16
    maxp = max_seq // page
    B, sp = 2, 8
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=(B, sp)).astype(np.int32))
    _, cache_d = tf.lm_prefill(params, cfg, {"tokens": toks}, max_seq)
    cache_p = tf.lm_paged_decode_init(params, cfg, B * maxp + 1, page, "cpu")
    table = torch.arange(B * maxp, dtype=torch.int32).reshape(B, maxp)
    _, cache_p = tf.lm_paged_prefill(params, cfg, {"tokens": toks}, cache_p,
                                     table[:, :sp // page])
    pos = torch.full((B,), sp, dtype=torch.int32)
    cur = toks[:, -1:]
    for _ in range(4):
        lg_d, cache_d = api.decode_step(params, cache_d, cur, pos)
        lg_p, cache_p = tf.lm_paged_decode_step(params, cfg, cache_p, cur,
                                                pos, table)
        torch.testing.assert_close(lg_p[:, -1], lg_d[:, -1], atol=1e-5,
                                   rtol=1e-5)
        cur = torch.argmax(lg_d[:, -1], -1).to(torch.int32)[:, None]
        pos = pos + 1


def test_engine_dense_paged_tokens_equal(smoke):
    """Greedy decode through the engine is token-identical across layouts,
    at the configs' default (bfloat16) dtypes."""
    api, params = smoke
    prompts = _prompts(5)
    outs = {}
    for paged in (False, True):
        eng = ServeEngine(api, params, n_slots=2, max_seq=64, paged=paged)
        reqs = [eng.submit(p, max_new=6) for p in prompts]
        eng.run()
        assert all(r.done for r in reqs)
        outs[paged] = [r.out for r in reqs]
    assert outs[False] == outs[True]


# ---------------------------------------------------------------------------
# slot refill / retirement / page lifecycle
# ---------------------------------------------------------------------------

def test_slot_refill_matches_solo(smoke):
    api, params = smoke
    prompts = _prompts(5, np.random.default_rng(3))
    news = [3, 7, 4, 6, 5]
    solo = []
    for p, n in zip(prompts, news):
        eng = ServeEngine(api, params, n_slots=1, max_seq=64, paged=True)
        r = eng.submit(p, max_new=n)
        eng.run()
        solo.append(r.out)
    eng = ServeEngine(api, params, n_slots=2, max_seq=64, paged=True)
    reqs = [eng.submit(p, max_new=n) for p, n in zip(prompts, news)]
    eng.run()
    assert eng.report()["prefill_calls"] >= 2     # multiple admission waves
    for r, want in zip(reqs, solo):
        assert r.done and r.out == want, (r.out, want)


def test_eos_retirement(smoke):
    api, params = smoke
    prompt = [3, 1, 4, 1, 5]
    ref = ServeEngine(api, params, n_slots=1, max_seq=64, paged=True)
    r0 = ref.submit(prompt, max_new=8)
    ref.run()
    eos = r0.out[1]               # eos is only checked on decode ticks
    stop = next(i for i in range(1, len(r0.out)) if r0.out[i] == eos)
    eng = ServeEngine(api, params, n_slots=1, max_seq=64, paged=True,
                      eos_id=eos)
    r = eng.submit(prompt, max_new=20)
    eng.run()
    assert r.done and r.out == r0.out[:stop + 1]


def test_max_new_and_max_seq_retirement(smoke):
    api, params = smoke
    eng = ServeEngine(api, params, n_slots=2, max_seq=32, paged=True,
                      page_size=16)
    short = eng.submit([1, 2, 3], max_new=3)
    capped = eng.submit(list(range(1, 29)), max_new=100)   # hits max_seq
    eng.run()
    assert short.done and len(short.out) == 3
    assert capped.done and len(capped.out) < 100
    assert len(capped.prompt) + len(capped.out) <= 32


def test_page_free_and_reuse(smoke):
    api, params = smoke
    eng = ServeEngine(api, params, n_slots=2, max_seq=32, paged=True,
                      page_size=8)
    assert eng.n_pages == 8
    reqs = [eng.submit(p, max_new=4) for p in _prompts(2)]
    eng.step()
    first = {pid for pages in eng._slot_pages for pid in pages}
    assert first and eng._trash not in first
    assert eng.pool_occupancy() == pytest.approx(len(first) / eng.n_pages)
    eng.run()
    assert all(r.done for r in reqs)
    assert sorted(eng._free) == list(range(eng.n_pages))   # all freed
    assert (eng._table_np == eng._trash).all()
    reqs2 = [eng.submit(p, max_new=4) for p in _prompts(2)]
    eng.step()
    second = {pid for pages in eng._slot_pages for pid in pages}
    assert first & second                                  # pages reused
    eng.run()
    assert all(r.done for r in reqs2)


def test_stall_and_resume(smoke):
    """A slot that cannot grow (empty free list) stalls with its state
    intact and resumes — producing the same tokens — once pages free up."""
    api, params = smoke
    prompt = [5, 6, 7]
    ref = ServeEngine(api, params, n_slots=2, max_seq=32, paged=True,
                      page_size=4)
    r_ref = ref.submit(prompt, max_new=10)
    ref.run()
    eng = ServeEngine(api, params, n_slots=2, max_seq=32, paged=True,
                      page_size=4)
    r = eng.submit(prompt, max_new=10)
    eng.step()
    stolen, eng._free = eng._free, []            # pool "exhausted"
    for _ in range(8):
        eng.step()
        if eng._stalled.any():
            break
    assert eng._stalled[0] and not eng.active[0] and not r.done
    eng._free = stolen
    eng.run()
    assert r.done and r.out == r_ref.out


def test_partial_resume_syncs_page_table(smoke):
    """Fewer free pages than stalled slots: the slots that do resume have
    their new page on the device table before the next tick, and the tokens
    match the dense engine's."""
    api, params = smoke
    prompts = [[5, 6, 7], [9, 2, 4]]
    ref = ServeEngine(api, params, n_slots=2, max_seq=32, paged=False)
    refs = [ref.submit(p, max_new=8) for p in prompts]
    ref.run()
    eng = ServeEngine(api, params, n_slots=2, max_seq=32, paged=True,
                      page_size=4)
    reqs = [eng.submit(p, max_new=8) for p in prompts]
    eng.step()
    stolen, eng._free = eng._free, []
    for _ in range(10):
        if eng._stalled.all():
            break
        eng.step()
    assert eng._stalled.all() and not any(r.done for r in reqs)
    eng._free = [stolen.pop()]                   # 1 page for 2 stalled slots
    eng.step()
    assert eng.active[0] and eng._stalled[1]     # partial resume
    np.testing.assert_array_equal(eng.page_table.numpy(), eng._table_np)
    eng.run()
    assert all(r.done for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in refs]


def test_pool_exhaustion_raises(smoke):
    api, params = smoke
    eng = ServeEngine(api, params, n_slots=2, max_seq=16, paged=True,
                      page_size=4, n_pages=4)
    for p in _prompts(2, lo=2, hi=4):
        eng.submit(p, max_new=14)               # both need all 4 pages
    with pytest.raises(RuntimeError, match="page pool exhausted"):
        eng.run()


def test_pool_below_single_request_rejected(smoke):
    api, params = smoke
    with pytest.raises(ValueError, match="pool smaller"):
        ServeEngine(api, params, n_slots=1, max_seq=32, paged=True,
                    page_size=4, n_pages=2)


def test_windowed_and_other_families_refused(smoke):
    """A window: the paged layout with the reference's message, the dense
    layout naming the reference's own fault; the ssm family is served on
    the dense layout; the encdec family is refused, naming the reference's
    ``KeyError: 'frames'``."""
    api, params = smoke
    windowed = dataclasses.replace(api, cfg=dataclasses.replace(
        api.cfg, window=16))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        ServeEngine(windowed, params)
    with pytest.raises(ValueError, match="without a sliding window"):
        ServeEngine(windowed, params, paged=True)
    ssm = build(configs.get_smoke_config("mamba2_780m"))
    assert not ServeEngine(ssm, ssm.init(0, "cpu")).paged
    whisper = build(configs.get_smoke_config("whisper_large_v3"))
    with pytest.raises(NotImplementedError,
                       match="KeyError: 'frames'.*ROADMAP queue 3"):
        ServeEngine(whisper, whisper.init(0, "cpu"))


# ---------------------------------------------------------------------------
# engine bookkeeping
# ---------------------------------------------------------------------------

def test_uids_monotonic_never_reused(smoke):
    api, params = smoke
    eng = ServeEngine(api, params, n_slots=1, max_seq=64)
    a = eng.submit([1, 2], max_new=2)
    eng.run()
    b = eng.submit([3, 4], max_new=2)
    c = eng.submit([5, 6], max_new=2)
    assert (a.uid, b.uid, c.uid) == (a.uid, a.uid + 1, a.uid + 2)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([])
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(list(range(64)))


def test_run_returns_late_and_stepped_completions(smoke):
    api, params = smoke
    eng = ServeEngine(api, params, n_slots=1, max_seq=64)
    a = eng.submit([1, 2, 3], max_new=2)
    while not a.done:
        eng.step()
    b = eng.submit([4, 5], max_new=2)
    done = eng.run()
    assert {r.uid for r in done} == {a.uid, b.uid}
    assert eng.run() == []


def _greedy_reference(api, params, prompt, n_new, max_seq=64):
    """Step-by-step greedy decode, single request, no engine."""
    tokens = torch.tensor([prompt], dtype=torch.int32)
    logits, cache = tf.lm_prefill(params, api.cfg, {"tokens": tokens},
                                  max_seq)
    out = [int(torch.argmax(logits[0, -1]))]
    pos = len(prompt)
    while len(out) < n_new:
        lg, cache = api.decode_step(params, cache,
                                    torch.tensor([[out[-1]]],
                                                 dtype=torch.int32),
                                    torch.full((1,), pos, dtype=torch.int32))
        out.append(int(torch.argmax(lg[0, -1])))
        pos += 1
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_engine_matches_step_by_step_greedy(smoke, paged):
    api, params = smoke
    prompt = [3, 1, 4, 1, 5]
    want = _greedy_reference(api, params, prompt, 6)
    eng = ServeEngine(api, params, n_slots=1, max_seq=64, paged=paged)
    r = eng.submit(prompt, max_new=6)
    eng.run()
    assert r.done and r.out == want


def test_continuous_batching_isolation(smoke):
    api, params = smoke
    prompts = [[5, 6, 7], [1, 2], [9, 8, 7, 6], [4, 4]]
    solo = []
    for p in prompts:
        eng = ServeEngine(api, params, n_slots=1, max_seq=64, paged=False)
        r = eng.submit(p, max_new=5)
        eng.run()
        solo.append(r.out)
    eng = ServeEngine(api, params, n_slots=2, max_seq=64, paged=False)
    reqs = [eng.submit(p, max_new=5) for p in prompts]
    eng.run()
    for r, want in zip(reqs, solo):
        assert r.done and r.out == want, (r.out, want)


def test_temperature_sampling_is_seeded(smoke):
    api, params = smoke
    outs = []
    for seed in (1, 1, 2):
        eng = ServeEngine(api, params, n_slots=2, max_seq=64,
                          temperature=1.0, seed=seed)
        reqs = [eng.submit(p, max_new=8) for p in _prompts(3)]
        eng.run()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1] and outs[0] != outs[2]


# ---------------------------------------------------------------------------
# against the reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["gemma_2b", ARCH])
def test_tokens_equal_the_reference_engine_f32(arch, paged):
    from repro import configs as ref_configs
    from repro.models.model import build as ref_build
    from repro.serve import ServeEngine as RefEngine

    rcfg = _f32(ref_configs.get_smoke_config(arch))
    rapi = ref_build(rcfg)
    rparams = rapi.init(jax.random.PRNGKey(0))
    api = build(_f32(configs.get_smoke_config(arch)))
    params = lm_params_to_torch(api.cfg, jax.tree.map(np.asarray, rparams))
    prompts = _prompts(5, np.random.default_rng(11), lo=2, hi=14)
    news = [5, 9, 3, 7, 6]
    outs = []
    for eng in (RefEngine(rapi, rparams, n_slots=2, max_seq=32,
                          paged=paged, page_size=8),
                ServeEngine(api, params, n_slots=2, max_seq=32, paged=paged,
                            page_size=8)):
        reqs = [eng.submit(p, max_new=n) for p, n in zip(prompts, news)]
        eng.run()
        assert all(r.done for r in reqs)
        outs.append([r.out for r in reqs])
        if paged:
            assert eng.report()["prefill_calls"] >= 2
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# snapshots (probe cells) are idempotent
# ---------------------------------------------------------------------------

def _flat(obj):
    if isinstance(obj, torch.Tensor):
        return [obj.clone()]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _flat(v)]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in _flat(v)]
    return []


@pytest.mark.parametrize("cell", ["prefill", "tick"])
def test_probe_cell_is_idempotent(smoke, cell):
    from repro_torch.serve.load import engine_for_probe

    api, params = smoke
    eng = engine_for_probe(api, params, slots=3, prompt=12, max_new=6,
                           page_size=8)
    pf_fn, pf_args, tk_fn, tk_args = eng.probe_cells()
    fn, args = (pf_fn, pf_args) if cell == "prefill" else (tk_fn, tk_args)
    first = _flat(fn(*args))
    cache_after = _flat(args[1])
    inputs = _flat(args[2:])
    second = _flat(fn(*args))
    assert len(first) == len(second)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.equal(a, b) for a, b in zip(cache_after,
                                                 _flat(args[1])))
    assert all(torch.equal(a, b) for a, b in zip(inputs, _flat(args[2:])))
    # each cell has its own cache: the engine's is left alone
    assert args[1]["kv"]["kp"] is not eng.cache["kv"]["kp"]


def test_probe_cells_need_a_paged_engine_with_a_wave(smoke):
    api, params = smoke
    with pytest.raises(RuntimeError, match="paged engine"):
        ServeEngine(api, params, paged=False).probe_cells()
    with pytest.raises(RuntimeError, match="admit at least one wave"):
        ServeEngine(api, params).probe_cells()


# ---------------------------------------------------------------------------
# the load harness and the serve region names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mix", ["quick", "chat", "long", "poisson"])
def test_request_streams_equal_the_reference(mix):
    from repro.serve import load as ref_load
    from repro_torch.serve import load

    assert (dataclasses.asdict(load.MIXES[mix])
            == dataclasses.asdict(ref_load.MIXES[mix]))
    assert (load.sample_requests(load.MIXES[mix], 256, 64)
            == ref_load.sample_requests(ref_load.MIXES[mix], 256, 64))


def test_run_load_drives_every_request(smoke):
    from repro_torch.serve.load import MIXES, run_load

    api, params = smoke
    eng = ServeEngine(api, params, n_slots=4, max_seq=64)
    rep = run_load(eng, MIXES["poisson"])
    assert rep["requests_done"] == rep["requests_total"] == 16
    assert rep["decode_tokens"] > 0 and rep["latency_ticks_p95"] >= \
        rep["latency_ticks_p50"]


@pytest.mark.parametrize("kw", [{}, {"slots": 2, "prompt": 8, "max_new": 4},
                                {"page_size": 8}])
def test_serve_region_names_equal_the_reference(kw):
    from repro.serve.load import serve_region_names as ref_names
    from repro_torch.serve.load import serve_region_names

    assert serve_region_names("gemma-2b", **kw) == ref_names("gemma-2b", **kw)


def test_launch_serve_cli_on_cpu(capsys):
    from repro_torch.launch.serve import main

    eng, reqs = main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                      "--requests", "3", "--max-new", "4"])
    assert eng.paged and all(r.done and len(r.out) == 4 for r in reqs)
    assert "3 requests on 4 slots (paged, cpu)" in capsys.readouterr().out


def test_load_cli_on_cpu(tmp_path):
    import json

    from repro_torch.serve.load import main

    rep = main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                "--dense", "--json", str(tmp_path / "r.json")])
    assert not rep["paged"] and rep["requests_done"] == 8
    assert json.loads((tmp_path / "r.json").read_text())["requests_done"] == 8


# ---------------------------------------------------------------------------
# the MoE and VLM families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "llava_next_34b"])
def test_moe_and_vlm_tokens_equal_the_reference_engine_f32(arch, paged):
    """Greedy tokens of qwen3 and llava smoke against the reference engine
    in the same layout. Prompts of at most 8 tokens on pages of 8: the
    reference's dense layout prefills one request at a time (T = its length
    <= 8 = the smallest capacity) where both layouts of the port prefill
    the wave (T = 2 x 8, capacity 16), so no layout drops a pair and the
    MoE routes every token alike (under drops, see the next test)."""
    from repro import configs as ref_configs
    from repro.models.model import build as ref_build
    from repro.serve import ServeEngine as RefEngine

    rcfg = _f32(ref_configs.get_smoke_config(arch))
    rapi = ref_build(rcfg)
    rparams = rapi.init(jax.random.PRNGKey(0))
    api = build(_f32(configs.get_smoke_config(arch)))
    params = lm_params_to_torch(api.cfg, jax.tree.map(np.asarray, rparams))
    prompts = _prompts(5, np.random.default_rng(12), lo=2, hi=9)
    news = [5, 9, 3, 7, 6]
    outs = []
    for eng in (RefEngine(rapi, rparams, n_slots=2, max_seq=32,
                          paged=paged, page_size=8),
                ServeEngine(api, params, n_slots=2, max_seq=32, paged=paged,
                            page_size=8)):
        reqs = [eng.submit(p, max_new=n) for p, n in zip(prompts, news)]
        eng.run()
        assert all(r.done for r in reqs)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]


def test_moe_drops_and_tokens_equal_the_reference_paged_engine_f32(
        monkeypatch):
    """Prompts up to 13 tokens on pages of 16: the wave's capacity drops
    pairs, and the port's paged engine still gives the reference paged
    engine's greedy tokens (the same rows routed at the same shapes)."""
    from repro import configs as ref_configs
    from repro.models.model import build as ref_build
    from repro.serve import ServeEngine as RefEngine
    from repro_torch.models import moe

    arch = "qwen3_moe_30b_a3b"
    rcfg = _f32(ref_configs.get_smoke_config(arch))
    rapi = ref_build(rcfg)
    rparams = rapi.init(jax.random.PRNGKey(0))
    api = build(_f32(configs.get_smoke_config(arch)))
    params = lm_params_to_torch(api.cfg, jax.tree.map(np.asarray, rparams))
    prompts = _prompts(6, np.random.default_rng(13), lo=4, hi=14)
    dropped = []
    combine = moe._group_combine

    def counting(out_buf, eg, slots, gates, capacity):
        dropped.append(int((slots >= capacity).sum()))
        return combine(out_buf, eg, slots, gates, capacity)

    monkeypatch.setattr(moe, "_group_combine", counting)
    outs = []
    for eng in (RefEngine(rapi, rparams, n_slots=3, max_seq=64, paged=True,
                          page_size=16),
                ServeEngine(api, params, n_slots=3, max_seq=64, paged=True,
                            page_size=16)):
        reqs = [eng.submit(p, max_new=6) for p in prompts]
        eng.run()
        outs.append([r.out for r in reqs])
    assert sum(dropped) > 0
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "llava_next_34b"])
def test_moe_and_vlm_layouts_token_equal_bf16(arch):
    """bf16, prompts up to 13 tokens (the MoE wave drops pairs): the dense
    layout prefills the wave at the paged layout's shapes and routes every
    slot a tick, so the two layouts' greedy tokens are equal."""
    api = build(configs.get_smoke_config(arch))
    params = api.init(0, "cpu")
    prompts = _prompts(7, np.random.default_rng(14), lo=2, hi=14)
    outs = []
    for paged in (True, False):
        eng = ServeEngine(api, params, n_slots=3, max_seq=64, paged=paged,
                          page_size=16)
        reqs = [eng.submit(p, max_new=5) for p in prompts]
        eng.run()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]


def test_mixtral_serving_refused_in_both_layouts():
    from repro_torch.launch.serve import main

    api = build(configs.get_smoke_config("mixtral_8x22b"))
    params = api.init(0, "cpu")
    with pytest.raises(ValueError, match="without a sliding window"):
        ServeEngine(api, params, paged=True)
    for paged in (None, False):
        with pytest.raises(NotImplementedError,
                           match="lm_prefill pads the KV.*ROADMAP queue 3"):
            ServeEngine(api, params, paged=paged)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        main(["--arch", "mixtral-8x22b", "--smoke", "--device", "cpu"])


def test_launch_serve_cli_serves_qwen3_smoke(capsys):
    from repro_torch.launch.serve import main

    eng, reqs = main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device",
                      "cpu", "--requests", "3", "--max-new", "4"])
    assert eng.paged and all(r.done and len(r.out) == 4 for r in reqs)
    dense, dreqs = main(["--arch", "qwen3-moe-30b-a3b", "--smoke",
                         "--device", "cpu", "--requests", "3", "--max-new",
                         "4", "--dense"])
    assert not dense.paged
    assert [r.out for r in dreqs] == [r.out for r in reqs]
    assert "3 requests on 4 slots (dense, cpu)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the ssm, hybrid and encdec families: the dense layout's sequential prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_1p2b"])
def test_sequential_prefill_tokens_equal_the_reference_engine_f32(arch):
    """Greedy tokens of mamba2 and zamba2 smoke against the reference
    engine, request for request, on the same weights: both serve on the
    dense layout (the default for these families), each admission replays
    its prompt through decode_step, slots refill as requests retire."""
    from repro import configs as ref_configs
    from repro.models.model import build as ref_build
    from repro.serve import ServeEngine as RefEngine
    from repro_torch.convert import params_to_torch

    rapi = ref_build(_f32(ref_configs.get_smoke_config(arch)))
    rparams = rapi.init(jax.random.PRNGKey(0))
    api = build(_f32(configs.get_smoke_config(arch)))
    params = params_to_torch(api.cfg, jax.tree.map(np.asarray, rparams))
    prompts = _prompts(5, np.random.default_rng(15), lo=2, hi=12)
    news = [5, 9, 3, 7, 6]
    outs = []
    for eng in (RefEngine(rapi, rparams, n_slots=2, max_seq=32),
                ServeEngine(api, params, n_slots=2, max_seq=32)):
        assert not eng.paged
        reqs = [eng.submit(p, max_new=n) for p, n in zip(prompts, news)]
        eng.run()
        assert all(r.done for r in reqs)
        assert eng.report()["prefill_calls"] == len(prompts)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_1p2b",
                                  "whisper_large_v3"])
def test_paged_serving_of_the_other_families_refused(arch):
    """``paged=True`` raises the reference's ValueError for the three
    families; the encdec family is refused on the dense layout too, naming
    the reference's ``KeyError: 'frames'``."""
    from repro import configs as ref_configs
    from repro.models.model import build as ref_build
    from repro.serve import ServeEngine as RefEngine

    api = build(configs.get_smoke_config(arch))
    params = api.init(0, "cpu")
    rapi = ref_build(ref_configs.get_smoke_config(arch))
    with pytest.raises(ValueError) as want:
        RefEngine(rapi, rapi.init(jax.random.PRNGKey(0)), paged=True)
    with pytest.raises(ValueError) as got:
        ServeEngine(api, params, paged=True)
    assert str(got.value) == str(want.value)
    if api.cfg.family == "encdec":
        with pytest.raises(KeyError, match="frames"):
            RefEngine(rapi, rapi.init(jax.random.PRNGKey(0)))
        for paged in (None, False):
            with pytest.raises(NotImplementedError,
                               match="KeyError: 'frames'"):
                ServeEngine(api, params, paged=paged)
    else:
        assert not ServeEngine(api, params).paged


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_launch_serve_cli_serves_the_ssm_families_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main

    eng, reqs = main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "3", "--max-new", "4"])
    assert not eng.paged and all(r.done and len(r.out) == 4 for r in reqs)
    assert eng.report()["prefill_calls"] == 3
    assert "3 requests on 4 slots (dense, cpu)" in capsys.readouterr().out


def test_sequential_prefill_scatters_one_slot_only():
    """An admission writes its own slot of every stacked leaf (along its
    "cache_batch" axis, 1 in every leaf, from ``cache_spec``) and leaves
    the other slots' state alone."""
    api = build(configs.get_smoke_config("zamba2_1p2b"))
    eng = ServeEngine(api, api.init(0, "cpu"), n_slots=3, max_seq=16)
    spec = api.cache_spec()
    assert set(spec) == set(eng.cache)
    before = {g: {n: t.clone() for n, t in leaves.items()}
              for g, leaves in eng.cache.items()}
    eng._admit(1, eng.submit([5, 6, 7], max_new=2))
    eng.queue.clear()
    for group, axes in spec.items():
        for name, logical in axes.items():
            ax = logical.index("cache_batch")
            assert ax == 1
            new, old = eng.cache[group][name], before[group][name]
            assert not torch.equal(new.select(ax, 1), old.select(ax, 1))
            for slot in (0, 2):
                assert torch.equal(new.select(ax, slot), old.select(ax, slot))
    assert eng.pos.tolist() == [0, 3, 0]
