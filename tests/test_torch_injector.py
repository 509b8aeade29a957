"""Step-level noise injection (``repro_torch.core.injector``) and the "step"
and "serve" plan kinds on the CPU, at smoke size:

* injection leaves the step's outputs bitwise unchanged for every default
  graph mode at k in {0, 1, 8} (the forward loss, a decode step, the serve
  engine's prefill and tick cells);
* ``inject_rt``'s aux equals ``inject``'s for k >= 1, and the regions'
  ``payload_check`` (the aux oracle) gives k;
* ``probe_step`` sweeps, fits and verifies its payload;
* the "step" and "serve" kinds validate, round-trip and resolve to the
  reference's region names (``repro.serve.load.serve_region_names``,
  ``repro.launch.probe.build_step_region``);
* a serve campaign and a step campaign classify and replay with 0 measured
  under the synthetic clock (``REPRO_SYNTH_MEASURE``), through the plan, the
  probe CLI and the fleet CLI.

On the card (tests marked ``cuda``, skipped here): the clean step is a CUDA
graph, and noisy outputs stay bitwise equal with the noise on its stream.
"""
import json

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.injector import (NoiseFork, inject, inject_rt,
                                       init_state, probe_step, step_modes,
                                       step_region, verify_semantics)
from repro_torch.fleet.plan import PlanError, SweepPlan, TargetSpec
from repro_torch.launch.probe import DEFAULT_GRAPH_MODES, build_step_region
from repro_torch.models.model import build

KS = (0, 1, 8)


@pytest.fixture(scope="module")
def registry():
    return step_modes("cpu")


@pytest.fixture(scope="module")
def steps():
    """(name, step_fn, args) of the steps the probes wrap."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.serve.load import engine_for_probe

    api = build(get_smoke_config("gemma_2b"))
    params = api.init(0, "cpu")
    batch = api.dummy_batch(ShapeConfig("p", "train", 16, 2), device="cpu")
    cache = api.decode_init(params, {"tokens": torch.zeros((2, 1)),
                                     "max_seq": 16})
    toks = torch.zeros((2, 1), dtype=torch.int32)
    pos = torch.tensor(8, dtype=torch.int32)
    eng = engine_for_probe(api, params, slots=2, prompt=8, max_new=4,
                           page_size=8)
    pf_fn, pf_args, tk_fn, tk_args = eng.probe_cells()
    return {
        "train": (lambda p, b: api.loss(p, b)[0], (params, batch)),
        "decode": (lambda p, c, t: api.decode_step(p, c, t, pos)[0],
                   (params, cache, toks)),
        "prefill": (pf_fn, pf_args),
        "tick": (tk_fn, tk_args),
    }


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mode", DEFAULT_GRAPH_MODES)
@pytest.mark.parametrize("step", ["train", "decode", "prefill", "tick"])
def test_injection_preserves_semantics_bitwise(steps, registry, step, mode,
                                               k):
    fn, args = steps[step]
    assert verify_semantics(fn, args, registry[mode], k=k)


@pytest.mark.parametrize("mode", DEFAULT_GRAPH_MODES)
def test_inject_rt_aux_equals_inject(steps, registry, mode):
    fn, args = steps["tick"]
    m = registry[mode]
    state = init_state(m)
    rt = inject_rt(fn, m)
    for k in (1, 5, 8):
        _, aux_s, st_s = inject(fn, m, k)(state, *args)
        _, aux_r, st_r = rt(k, state, *args)
        assert torch.equal(aux_s, aux_r)
        for a, b in zip(torch.utils._pytree.tree_leaves(st_s),
                        torch.utils._pytree.tree_leaves(st_r)):
            assert torch.equal(a, b)


def test_verify_semantics_catches_a_changed_output(steps, registry):
    fn, args = steps["train"]
    calls = []

    def drifting(*a):
        calls.append(1)
        return fn(*a) + len(calls)
    assert not verify_semantics(drifting, args, registry["fp_add32"], k=1)


def test_noise_fork_on_the_cpu_runs_step_then_noise(registry):
    order = []
    m = registry["fp_add32"]

    def step():
        order.append("step")
        return torch.ones(1)

    def apply(state, k):
        order.append("noise")
        return m.apply(state, k)
    out, aux, _ = NoiseFork().run(step, apply, init_state(m), 3, (), {})
    assert order == ["step", "noise"] and torch.equal(out, torch.ones(1))


@pytest.mark.parametrize("mode", DEFAULT_GRAPH_MODES)
def test_step_region_builds_and_payload_check(steps, registry, mode):
    fn, args = steps["prefill"]
    region = step_region("r", fn, args, {mode: registry[mode]})
    assert region.build("", 0) is fn and region.args_for("", 0) is args
    assert region.audit_hint == {"scoped": True, "in_loop": False}
    out, aux, _ = region.build_rt(mode)(4, *region.args_for_rt(mode))
    assert aux.numel() == 1
    for k in (1, 16):
        rep = region.payload_check(mode, k)
        assert (rep.payload, rep.expected, rep.overhead) == (k, k, 0)
        assert rep.target == registry[mode].target and rep.ok()
    assert region.payload_check(mode, 0).survival_fraction == 1.0


def test_payload_check_reports_zero_when_the_aux_differs(steps, registry):
    from repro_torch.core.noise import NoiseMode
    import dataclasses

    fn, args = steps["train"]
    m = registry["fp_add32"]

    def short(state, k, plain=False):   # drops one pattern unless plain
        return m.apply(state, k if plain else k - 1, plain=plain)
    bad = dataclasses.replace(m, apply=short)
    assert isinstance(bad, NoiseMode)
    rep = step_region("r", fn, args, {"fp_add32": bad}).payload_check(
        "fp_add32", 8)
    assert rep.payload == 0 and not rep.ok()


def test_probe_step_sweeps_and_verifies(steps, registry, monkeypatch):
    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")
    fn, args = steps["decode"]
    for compile_once in (True, False):
        res = probe_step(fn, args, registry["vmem_ld"], ks=(0, 1, 4, 8, 16),
                         reps=1, compile_once=compile_once)
        assert res.curve.ks == [0, 1, 4, 8, 16]
        # the synthetic clock reads k from a run-time k argument; the
        # static builds carry k in the callable, so it reads them flat
        assert res.fit.k1 == (6.0 if compile_once else 16.0)
        assert res.injection.payload == res.injection.expected == 8


# ---------------------------------------------------------------------------
# the plan kinds
# ---------------------------------------------------------------------------

def test_step_and_serve_plan_round_trip_with_the_reference_names(tmp_path):
    from repro.fleet.plan import SweepPlan as RefPlan
    from repro.fleet.plan import TargetSpec as RefSpec
    from repro.launch.probe import build_step_region as ref_step_region
    from repro.serve.load import serve_region_names as ref_serve_names

    specs = [("serve", {"arch": "gemma_2b", "slots": 2, "prompt": 8,
                        "max_new": 4}),
             ("step", {"arch": "deepseek-coder-33b", "kind": "decode",
                       "seq": 16, "batch": 2}),
             ("step", {"arch": "gemma_2b"})]
    plan = SweepPlan(name="t", store=str(tmp_path / "s.jsonl"),
                     targets=[TargetSpec(k, ("fp_add32", "hbm_stream"), p)
                              for k, p in specs], reps=1, backend="cpu")
    ref = RefPlan(name="t", store=str(tmp_path / "s.jsonl"),
                  targets=[RefSpec(k, ("fp_add32", "hbm_stream"), p)
                           for k, p in specs], reps=1, backend="cpu")
    plan.validate()
    assert plan.grid() == ref.grid()
    names = [n for spec in plan.targets for n in spec.region_names()]
    assert names[:2] == ref_serve_names("gemma_2b", slots=2, prompt=8,
                                        max_new=4)
    assert names[2] == ref_step_region("deepseek-coder-33b", "decode",
                                       ["fp_add32"], seq=16, batch=2).name
    assert names[3] == "gemma-2b-smoke_train_s128_b4"
    assert [r.name for r, _ in plan.pairs()][::2] == names
    path = plan.save(str(tmp_path / "plan.json"))
    again = SweepPlan.load(path)
    assert again.digest() == plan.digest() and again.grid() == plan.grid()


@pytest.mark.parametrize("spec,match", [
    (TargetSpec("serve", ("fp_add32",), {"arch": "gemma_2b", "slots": 0}),
     "slots"),
    (TargetSpec("serve", ("fp_add32",), {}), "arch"),
    (TargetSpec("serve", ("fp_add32",), {"arch": "mixtral_8x22b"}),
     "sliding-window config"),
    (TargetSpec("step", ("fp_add32",), {"arch": "gpt-17"}),
     "unknown architecture"),
    (TargetSpec("serve", ("fp",), {"arch": "gemma_2b"}),
     "unknown graph-level mode"),
], ids=["slots", "arch", "moe", "unknown-arch", "mode"])
def test_model_plan_refusals(spec, match):
    with pytest.raises(PlanError, match=match):
        spec.validate()


def test_step_region_names_at_the_cli_defaults():
    region = build_step_region("gemma-2b", "decode", ["fp_add32"], seq=128,
                               batch=4, device="cpu")
    assert region.name == "gemma-2b-smoke_decode_s128_b4"
    assert TargetSpec("serve", ("fp_add32",), {
        "arch": "gemma-2b", "prompt": 128, "slots": 4}).region_names() == [
        "gemma-2b-smoke_serve_prefill_s128_n8_p16_b4",
        "gemma-2b-smoke_serve_decode_s128_n8_p16_b4"]


def test_model_targets_on_the_card_need_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TargetSpec("step", ("fp_add32",), {"arch": "gemma_2b"}).resolve()


# ---------------------------------------------------------------------------
# campaigns: classify, then replay with 0 measured
# ---------------------------------------------------------------------------

def test_serve_campaign_classifies_and_replays(tmp_path, monkeypatch):
    from repro_torch.fleet.executor import run_worker

    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")
    plan = SweepPlan(
        name="serve-test", store=str(tmp_path / "serve.jsonl"),
        targets=[TargetSpec("serve", ("fp_add32", "hbm_stream"),
                            {"arch": "gemma_2b", "slots": 2, "prompt": 8,
                             "max_new": 4})],
        reps=1, backend="cpu")
    plan.validate()
    reports, stats = run_worker(plan, fresh=True)
    assert stats.measured > 0
    names = sorted(reports)
    assert names == sorted(plan.targets[0].region_names())
    for rep in reports.values():
        assert rep.bottleneck.label
        for res in rep.results.values():
            assert res.injection.payload == res.injection.expected > 0
    reports2, stats2 = run_worker(plan, expect_no_measure=True)
    assert stats2.measured == 0 and stats2.cached > 0
    assert sorted(reports2) == names
    assert {n: r.bottleneck.label for n, r in reports2.items()} == \
        {n: r.bottleneck.label for n, r in reports.items()}


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_probe_cli_step_campaign_replays(tmp_path, monkeypatch, kind):
    from repro_torch.launch.probe import main

    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")
    store = str(tmp_path / "step.jsonl")
    argv = ["--arch", "gemma-2b", "--kind", kind, "--seq", "32", "--batch",
            "2", "--modes", "fp_add32,mxu_fma128", "--reps", "1",
            "--device", "cpu", "--store", store]
    reports, stats = main(argv)
    assert stats.measured > 0
    assert list(reports) == [f"gemma-2b-smoke_{kind}_s32_b2"]
    _, again = main(argv + ["--expect-no-measure"])
    assert again.measured == 0


def test_probe_cli_serve_campaign_replays(tmp_path, monkeypatch):
    from repro_torch.launch.probe import main

    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")
    argv = ["--serve", "--arch", "gemma-2b", "--seq", "8", "--batch", "2",
            "--max-new", "4", "--modes", "vmem_ld", "--reps", "1",
            "--device", "cpu", "--store", str(tmp_path / "serve.jsonl")]
    reports, _ = main(argv)
    assert sorted(reports) == sorted([
        "gemma-2b-smoke_serve_prefill_s8_n4_p16_b2",
        "gemma-2b-smoke_serve_decode_s8_n4_p16_b2"])
    _, again = main(argv + ["--expect-no-measure"])
    assert again.measured == 0


def test_probe_cli_flag_conflicts():
    from repro_torch.launch.probe import main

    with pytest.raises(SystemExit, match="--arch is required"):
        main(["--device", "cpu"])
    with pytest.raises(SystemExit, match="--pallas excludes --serve"):
        main(["--pallas", "probe", "--serve", "--device", "cpu"])
    with pytest.raises(SystemExit, match="drop the conflicting"):
        main(["--plan", "p.json", "--arch", "gemma-2b"])


def test_fleet_cli_plans_and_runs_a_serve_target(tmp_path, monkeypatch):
    from repro_torch.fleet.cli import main

    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")
    path = str(tmp_path / "serve.plan.json")
    assert main(["plan", "--out", path, "--arch", "gemma-2b", "--serve",
                 "--seq", "8", "--batch", "2", "--max-new", "4",
                 "--modes", "fp_add32", "--shards", "1", "--reps", "1",
                 "--backend", "cpu", "--launcher", "local",
                 "--store", str(tmp_path / "serve.jsonl")]) == 0
    with open(path) as f:
        d = json.load(f)
    assert d["targets"] == [{"kind": "serve", "modes": ["fp_add32"],
                             "params": {"arch": "gemma-2b", "slots": 2,
                                        "prompt": 8, "max_new": 4}}]
    assert d["name"] == "fleet_gemma-2b_serve"
    with pytest.raises(SystemExit, match="exactly one of"):
        main(["plan", "--out", path, "--arch", "gemma-2b", "--pallas",
              "probe"])
    with pytest.raises(SystemExit, match="--serve needs --arch"):
        main(["plan", "--out", path, "--pallas", "probe", "--serve"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the step regions "
                    "there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_step_region_is_a_graph_and_noise_keeps_it_bitwise(card):
    from repro_torch.core.injector import GraphStep
    from repro_torch.serve.load import build_serve_regions

    regions = build_serve_regions("gemma_2b", DEFAULT_GRAPH_MODES,
                                  slots=2, prompt=8, max_new=4, device=card)
    for region in regions:
        clean = region.build("", 0)
        assert isinstance(clean, GraphStep)
        want = [t.clone() for t in
                torch.utils._pytree.tree_leaves(clean(*region.args_for("",
                                                                       0)))]
        for mode in DEFAULT_GRAPH_MODES:
            out, _, _ = region.build_rt(mode)(64, *region.args_for_rt(mode))
            got = torch.utils._pytree.tree_leaves(out)
            assert all(torch.equal(a, b) for a, b in zip(want, got))
            assert region.payload_check(mode, 64).payload == 64
