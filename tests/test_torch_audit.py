"""The static noise audit over SASS (``repro_torch.analysis``, ``sass``) on
the CPU: the parser, every corruption class and the direction rule on
synthetic SASS, the record round trip, the golden fixtures captured on the
card (``tests/golden_torch/``: ``python -m repro_torch.analysis.capture``),
the fleet's gate and ``fleet audit``, and the payload census.

The CPU box has no ``nvcc`` and no ``cuobjdump``: the builds are never made
here. Where a test needs SASS of a region it reads the fixtures, or
synthetic text injected in place of ``_build.site_sass``.
"""
import gzip
import json
import os

import pytest

from repro.analysis import audit as ref_audit
from repro_torch.analysis import audit as au
from repro_torch.analysis.graph import chain_depth, defuse_edges
from repro_torch.analysis.resources import (BANDWIDTH_OPS, SERIAL_CHAIN_FRAC,
                                            TARGET_FAMILY, access_bytes,
                                            predict_direction)
from repro_torch.core import payload as pm
from repro_torch.core.campaign import CampaignStore
from repro_torch.core.controller import (RegionTarget, census_payload,
                                         derive_body_size)
from repro_torch.kernels import _build
from repro_torch.kernels._build import SassSite
from repro_torch.sass.parse import base_name, parse_sass, select

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden_torch")
FIXTURES = sorted(f[:-len(".json.gz")]
                  for f in os.listdir(os.path.join(GOLDEN, "sass"))
                  if f.endswith(".json.gz")) \
    if os.path.isdir(os.path.join(GOLDEN, "sass")) else []


# ---------------------------------------------------------------------------
# synthetic SASS, laid out as cuobjdump prints it
# ---------------------------------------------------------------------------

def sass(*funcs) -> str:
    """A dump of (mangled name, [instruction or "label:"]) functions, with
    addresses every 16 bytes and the encoding comments cuobjdump adds."""
    out = ["", "Fatbin elf code:", "================", "arch = sm_90a",
           "\tcode for sm_90a"]
    for name, body in funcs:
        out += [f"\t\tFunction : {name}",
                '\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_SM90"']
        addr = 0
        for ins in body:
            if ins.endswith(":"):
                out.append(ins)
                continue
            out.append(f"        /*{addr:04x}*/                   {ins} ;"
                       "                 /* 0x000fe40000000800 */")
            out.append(" " * 70 + "/* 0x000fc80000000f00 */")
            addr += 16
        out.append("        ..........")
    return "\n".join(out) + "\n"


def kernel(k: int, pattern=("FADD R3, R3, R2",), *, name="probe_kernel",
           in_loop=True, extra=(), aux=None) -> str:
    """A loop kernel with ``k`` copies of ``pattern`` in its body (or
    before the loop), mangled with k in its template arguments as the
    static builds are."""
    noise = [p for _ in range(k) for p in pattern]
    body = ["S2R R0, SR_TID.X", "IMAD.MOV.U32 R3, RZ, RZ, RZ"]
    if not in_loop:
        body += noise
    body += [".L_x_0:", "LDG.E R2, desc[UR4][R4.64]"]
    if in_loop:
        body += noise
    body += [*extra, "IADD3 R0, R0, 0x1, RZ",
             "ISETP.GE.AND P0, PT, R0, 0x10, PT", "@!P0 BRA `(.L_x_0)",
             "STG.E desc[UR4][R6.64], R3", "EXIT", ".L_x_1:",
             "BRA `(.L_x_1)", "NOP", "NOP"]
    funcs = [(f"_Z{len(name)}{name}ILi1ELi{k}EEvPKfPf", body)]
    if aux is not None:
        funcs.append(("_ZL11nacc_reducePKfiiPf", aux))
    return sass(*funcs)


def audit3(make, target="compute", hint=None, ks=(0, 4, 12)):
    return au.audit_texts(*(make(k) for k in ks), region="r", mode="m",
                          target=target, hint=hint)


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------

def test_parser_reads_functions_labels_and_predicates():
    text = kernel(2)
    (name, fn), = parse_sass(text).items()
    assert name.startswith("_Z12probe_kernelILi1ELi2EE")
    assert fn.base == "probe_kernel" and fn.tail.startswith("ILi1ELi2EE")
    assert fn.labels == {".L_x_0": 0x20, ".L_x_1": 0xa0}
    bra = [i for i in fn.instrs if i.op == "BRA"]
    assert [(b.guard, b.target, b.src) for b in bra] == [
        ("!P0", ".L_x_0", ("P0",)), ("", ".L_x_1", ())]
    ldg = next(i for i in fn.instrs if i.op == "LDG")
    assert ldg.opcode == "LDG.E" and ldg.dst == ("R2",)
    assert ldg.src == ("UR4", "R4", "R5")            # R4.64: a pair
    setp = next(i for i in fn.instrs if i.op == "ISETP")
    assert setp.dst == ("P0",) and setp.src == ("R0",)   # PT is no register
    stg = next(i for i in fn.instrs if i.op == "STG")
    assert stg.dst == () and stg.src == ("UR4", "R6", "R7", "R3")
    wide = pm.census_op("IMAD.MOV.U32")
    assert wide == "MOV" and pm.census_op("IMAD.WIDE.U32") == "IMAD"


def test_loop_depth_from_nested_backward_branches_in_both_forms():
    """An outer loop closed by a label branch and an inner one closed by an
    address branch (the two forms cuobjdump prints); the branch that parks a
    thread after EXIT is not a loop."""
    body = ["S2R R0, SR_TID.X",                  # 0x00 depth 0
            ".L_x_3:",
            "FADD R1, R1, R1",                    # 0x10 depth 1
            "FADD R2, R2, R2",                    # 0x20 depth 2 (inner top)
            "ISETP.NE.AND P1, PT, R2, RZ, PT",    # 0x30 depth 2
            "@P1 BRA 0x20",                       # 0x40 depth 2
            "ISETP.NE.AND P0, PT, R1, RZ, PT",    # 0x50 depth 1
            "@P0 BRA `(.L_x_3)",                  # 0x60 depth 1
            "EXIT",                               # 0x70 depth 0
            ".L_x_4:",
            "BRA `(.L_x_4)"]                      # 0x80 depth 0
    fn, = parse_sass(sass(("_Z1fv", body))).values()
    assert [i.depth for i in fn.instrs] == [0, 1, 2, 2, 2, 1, 1, 0, 0]
    assert fn.instrs[4].target == "0x20"


def test_base_names_of_mangled_kernels():
    assert base_name("_Z13stream_kernelILi1ELi8EEvPKfS0_Pf") == \
        ("stream_kernel", "ILi1ELi8EEvPKfS0_Pf")
    assert base_name("_ZL11nacc_reducePKfiiPf")[0] == "nacc_reduce"
    assert base_name("_ZN12_GLOBAL__N_14gfoxILi3EEEvv")[0] == "gfox"
    assert base_name("repro_plain_c") == ("repro_plain_c", "")
    two = sass(("_Z9t3_kernelILi0ELb1ELb1ELi1ELi4EEv", ["EXIT"]),
               ("_Z9t3_kernelILi1ELb1ELb1ELi1ELi4EEv", ["EXIT"]))
    kept = parse_sass(select(two, (("t3_kernel", "ILi1E"),)))
    assert list(kept) == ["_Z9t3_kernelILi1ELb1ELb1ELi1ELi4EEv"]
    assert select(two, (("other", ""),)) == ""


def test_defuse_graph_and_chain_depth_through_uncounted_links():
    """A pointer chase: each LDG's address comes from the value the last one
    loaded through an IMAD.WIDE; independent loads chain nothing."""
    chase = ["LDG.E R3, desc[UR4][R4.64]"]
    for _ in range(5):
        chase += ["IMAD.WIDE R4, R3, 0x4, R6", "LDG.E R3, desc[UR4][R4.64]"]
    fn, = parse_sass(sass(("_Z1cv", chase))).values()
    edges = defuse_edges(fn.instrs)
    assert edges[1] == [0] and edges[2] == [1]
    assert chain_depth(fn.instrs, lambda i: i.op in BANDWIDTH_OPS) == 6
    flat = [f"LDG.E R{10 + j}, desc[UR4][R4.64+0x{j * 16:x}]"
            for j in range(6)]
    fn, = parse_sass(sass(("_Z1fv", flat))).values()
    assert chain_depth(fn.instrs, lambda i: i.op in BANDWIDTH_OPS) == 1


def test_access_bytes_from_width_modifiers():
    assert access_bytes("LDG.E") == 4
    assert access_bytes("LDG.E.128.CONSTANT") == 16
    assert access_bytes("LDS.64") == 8
    assert access_bytes("LDG.E.U8") == 1
    assert access_bytes("LDSM.16.M88.4") == 16


def test_vocabularies_are_the_references_where_framework_neutral():
    assert TARGET_FAMILY == ref_audit.TARGET_FAMILY
    assert SERIAL_CHAIN_FRAC == 0.75
    assert (au.K_LO, au.K_HI) == (ref_audit.K_LO, ref_audit.K_HI)
    assert set(pm.PAYLOAD_OPS) == {"compute", "l1", "vmem", "memory",
                                   "latency", "ici"}


# ---------------------------------------------------------------------------
# every corruption class and verdict, on synthetic SASS
# ---------------------------------------------------------------------------

HINT = {"scoped": False, "in_loop": True, "steps": 8,
        "kernels": ["probe_kernel"]}


def test_intact_scales_one_for_one_and_agrees():
    rep = audit3(kernel, hint=HINT)
    assert (rep.verdict, rep.corruption) == ("intact", None)
    assert rep.survival == 1.0 and rep.predicted == "compute" and rep.agrees
    assert rep.resources["compute"] == 1.0
    assert rep.detail == "FADD@d1/probe_kernel:+8"


def test_census_keys_line_up_across_template_arguments():
    """The lo and hi builds' mangled names differ (k is a template
    argument); keyed by base name their fixed code cancels exactly."""
    c4, c12 = (au.take_census(kernel(k), kernels={"probe_kernel"})
               for k in (4, 12))
    assert au._delta(c12.counts, c4.counts) == {
        ("FADD", 1, "probe_kernel"): 8}


def test_dead_by_dce():
    rep = audit3(lambda k: kernel(0), hint=HINT)
    assert (rep.verdict, rep.corruption) == ("dead", "dce")
    assert not rep.ok and rep.predicted == "none" and rep.agrees is None


def test_dead_by_strength_reduction():
    """k adds folded to one multiply: the payload does not scale, and the
    build gained an FFMA over the clean one (compute targets only)."""
    def make(k):
        return kernel(0, extra=("FFMA R3, R2, 4, R3",) if k else ())
    rep = audit3(make, hint=HINT)
    assert (rep.verdict, rep.corruption) == ("dead", "strength_reduction")
    rep = audit3(make, target="vmem", hint=HINT)
    assert rep.corruption == "dce"


def test_dead_by_constant_folding():
    """Folded to a constant: only a move of an immediate is left."""
    def make(k):
        return kernel(0, extra=("MOV R9, 0x41400000",) if k else ())
    rep = audit3(make, hint=HINT)
    assert (rep.verdict, rep.corruption) == ("dead", "constant_folding")


def test_degraded_by_partial_elision():
    def make(k):
        return kernel(k // 2)
    rep = audit3(make, hint=HINT)
    assert (rep.verdict, rep.corruption) == ("degraded", "partial_elision")
    assert rep.survival == 0.5 and rep.ok


def test_degraded_by_loop_invariant_hoisting():
    rep = audit3(lambda k: kernel(k, in_loop=False), hint=HINT)
    assert (rep.verdict, rep.corruption) == ("degraded",
                                             "loop_invariant_hoisting")


def test_degraded_by_fusion_into_consumer():
    """The payload scales only in a kernel a call runs once (beside the
    region's own)."""
    def make(k):
        return kernel(0, aux=["FADD R3, R3, R2"] * k + ["EXIT"])
    rep = audit3(make, hint=HINT)
    assert (rep.verdict, rep.corruption) == ("degraded",
                                             "fusion_into_consumer")


def test_one_step_per_cta_places_noise_outside_any_loop():
    """On the card a CTA of one grid step holds its noise at depth 0: with
    ``steps`` = 1 that is intact, not hoisted; loop regions (no ``steps``)
    expect the loop their kernel has."""
    one = dict(HINT, steps=1)
    assert audit3(lambda k: kernel(k, in_loop=False), hint=one).verdict \
        == "intact"
    loop = {"scoped": True, "in_loop": True}
    assert audit3(lambda k: kernel(k, in_loop=False), hint=loop).corruption \
        == "loop_invariant_hoisting"
    step = {"scoped": True, "in_loop": False}
    assert audit3(lambda k: kernel(k, in_loop=False), hint=step).verdict \
        == "intact"


@pytest.mark.parametrize("pattern,target,predicted,agrees", [
    (("FADD R3, R3, R2",), "compute", "compute", True),
    (("LDS R8, [R9+0x40]", "FADD R3, R3, R8"), "vmem", "bandwidth", True),
    (("LDG.E R8, desc[UR4][R10.64]", "FADD R3, R3, R8"), "memory",
     "bandwidth", True),
    (("IMAD.WIDE R4, R2, 0x4, R6", "LDG.E R2, desc[UR4][R4.64]"), "latency",
     "latency", True),
    (("LDS R8, [R9]", "HMMA.1688.F32.TF32 R12, R8, R10, R12"), "compute",
     "bandwidth", False),
], ids=["fp", "vmem", "stream", "chase", "mxu-operands-from-shared"])
def test_direction_rule(pattern, target, predicted, agrees):
    """Load-family growth dominates the arithmetic it feeds; a load chain
    growing a link a pattern is a pointer chase (latency)."""
    rep = audit3(lambda k: kernel(k, pattern), target=target, hint=HINT)
    assert rep.verdict == "intact"
    assert (rep.predicted, rep.agrees) == (predicted, agrees)
    assert predict_direction({}, 0, 8) == "none"


def test_vmem_pressure_counts_bytes_a_thread_moves():
    rep = audit3(lambda k: kernel(k, ("LDS.64 R8, [R20]",
                                      "FADD R3, R3, R8")),
                 target="vmem", hint=HINT)
    assert rep.resources == {"bandwidth": 8.0, "compute": 1.0,
                             "ici": 0.0, "latency": 0.0}


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------

def test_record_round_trips_like_the_reference():
    rep = audit3(lambda k: kernel(k // 2), hint=HINT)
    d = rep.to_dict()
    assert set(d) == {f.name for f in
                      ref_audit.AuditReport.__dataclass_fields__.values()}
    back = au.AuditReport.from_dict({**d, "kind": "audit", "extra": 1})
    assert back.to_dict() == d and back.explain() == rep.explain()
    # the reference reads the record alike
    assert ref_audit.AuditReport.from_dict(d).to_dict() == d
    assert rep.explain().startswith("r × m: degraded (survival 50%/pattern, "
                                    "predicts compute) — only part of the "
                                    "payload survives per pattern")


def test_records_persist_in_the_store(tmp_path):
    store = CampaignStore(str(tmp_path / "s.jsonl"))
    rep = audit3(kernel, hint=HINT)
    store.append({"kind": "audit", **rep.to_dict()})
    store.close()
    back = CampaignStore(str(tmp_path / "s.jsonl"), readonly=True)
    assert back.audits[("r", "m")]["verdict"] == "intact"


# ---------------------------------------------------------------------------
# the golden fixtures: SASS of the main-path kernel regions, a graph mode
# and the sabotaged probe, captured on the H100
# ---------------------------------------------------------------------------

def _fixture(name: str) -> dict:
    with gzip.open(os.path.join(GOLDEN, "sass", name + ".json.gz"),
                   "rt") as f:
        return json.load(f)


def _expected() -> dict:
    with open(os.path.join(GOLDEN, "audit_expected.json")) as f:
        return json.load(f)


def test_golden_fixtures_are_present():
    assert FIXTURES and sorted(_expected()) == FIXTURES
    kernels = {n.split("__")[0] for n in FIXTURES}
    assert {"pallas_probe_s1056", "pallas_spmxv_n2097152_L16_q0",
            "pallas_matmul_n4096", "pallas_attn_b1h32s4096d128"} <= kernels
    assert any(n.endswith("__sabotaged") for n in FIXTURES)


@pytest.mark.parametrize("name", FIXTURES)
def test_golden_fixture_audits_to_the_expected_report(name):
    fx = _fixture(name)
    rep = au.audit_texts(fx["clean"], fx["lo"], fx["hi"],
                         region=fx["region"], mode=fx["mode"],
                         target=fx["target"], hint=fx["hint"],
                         k_lo=fx["k_lo"], k_hi=fx["k_hi"])
    assert rep.to_dict() == _expected()[name]


def test_golden_main_path_pairs_are_intact_and_the_sabotage_dead():
    exp = _expected()
    for name, rec in exp.items():
        if name.endswith("__sabotaged"):
            assert rec["verdict"] == "dead" and rec["corruption"], name
        else:
            assert rec["verdict"] == "intact", (name, rec)


@pytest.mark.parametrize("name", [n for n in FIXTURES
                                  if not n.endswith("sabotaged")])
def test_body_size_from_fixture_sass(name, monkeypatch):
    """``derive_body_size`` reads |l1.l2| from the clean build's SASS: a
    nonzero count for a kernel region, 0 for a step region (its clean step
    is a CUDA graph of library kernels)."""
    fx = _fixture(name)
    kernels = tuple((k, "") for k in fx["hint"]["kernels"])
    monkeypatch.setattr(_build, "site_sass", lambda site: fx["clean"])
    step = not fx["hint"].get("in_loop", True)
    target = RegionTarget(
        name=fx["region"], build=None, args_for=None,
        sass=lambda mode, k: SassSite("x", 0, k, kernels=kernels,
                                      body=not step))
    body = derive_body_size(target)
    if step:
        assert body == 0
    else:
        assert body == pm.body_size(fx["clean"],
                                    kernels=set(fx["hint"]["kernels"])) > 0


def test_payload_census_of_a_step_and_a_loop_report(monkeypatch):
    """Step and loop InjectionReports: payload from the aux oracle,
    ``overhead`` (non-family instructions the k build adds) and
    ``body_ops`` from the census of the k build against the clean one."""
    fx = _fixture(next(n for n in FIXTURES if "hbm_latency" in n))
    texts = {0: fx["clean"], au.K_LO: fx["lo"]}
    monkeypatch.setattr(_build, "site_sass", lambda site: texts[site.k])
    kernels = tuple((k, "") for k in fx["hint"]["kernels"])
    target = RegionTarget(
        name="step", build=None, args_for=None,
        sass=lambda mode, k: SassSite("graph_noise", 5, k, kernels=kernels,
                                      body=False))
    cen = census_payload(target, "hbm_latency", au.K_LO, expected=au.K_LO)
    assert cen.payload >= au.K_LO and cen.overhead > 0 and cen.body_ops > 0
    aux = pm.analyze_aux(*(pm.torch.ones(1),) * 2, mode="hbm_latency",
                         target="latency", expected=au.K_LO)
    rep = pm.with_census(aux, cen)
    assert (rep.payload, rep.overhead, rep.body_ops) == (
        au.K_LO, cen.overhead, cen.body_ops)
    # a loop kernel: the synthetic loop's l1_ld patterns
    texts = {0: kernel(0), 24: kernel(24, ("LDG.E R8, desc[UR4][R10.64]",
                                           "IADD3 R10, R10, 0x40, RZ",
                                           "FADD R3, R3, R8"))}
    loop = RegionTarget(
        name="loop", build=None, args_for=None,
        sass=lambda mode, k: SassSite("loop_regions", 3, k,
                                      kernels=(("probe_kernel", ""),)))
    cen = census_payload(loop, "l1_ld", 24, expected=24, trips=10)
    assert (cen.payload, cen.overhead, cen.payload_dynamic) == (24, 48, 240)
    assert cen.body_ops == 3     # the clean loop's LDG, IADD3 and ISETP
    assert census_payload(RegionTarget("cpu", None, None), "l1_ld", 24,
                          expected=24) is None


# ---------------------------------------------------------------------------
# unauditable pairs: never a verdict
# ---------------------------------------------------------------------------

def test_missing_cuobjdump_raises_audit_error(monkeypatch):
    monkeypatch.setattr(_build, "static_build", lambda *a, **kw: "lib.so")
    monkeypatch.setattr(_build, "cuobjdump_path", lambda: None)
    site = SassSite("noise_probes", 1, 4, kernels=(("probe_kernel", ""),))
    with pytest.raises(au.AuditError, match="no cuobjdump"):
        au.site_text(site)
    target = RegionTarget("r", None, None, sass=lambda m, k: site)
    with pytest.raises(au.AuditError, match="r × fp"):
        au.audit_pair(target, "fp")


def test_a_build_without_the_regions_functions_is_unauditable(monkeypatch):
    monkeypatch.setattr(_build, "site_sass", lambda site: "")
    site = SassSite("noise_probes", 1, 4, kernels=(("probe_kernel", ""),))
    with pytest.raises(au.AuditError, match="holds none of the functions"):
        au.site_text(site)


def test_a_failed_build_is_unauditable(monkeypatch):
    def fail(*a, **kw):
        raise RuntimeError("nvcc failed: boom")
    monkeypatch.setattr(_build, "static_build", fail)
    site = SassSite("noise_probes", 1, 4, kernels=(("probe_kernel", ""),))
    with pytest.raises(au.AuditError, match="static build failed.*boom"):
        au.site_text(site)


def test_cpu_regions_have_no_sass_site():
    from repro_torch.bench.kernels import stream_region
    from repro_torch.kernels.region import pallas_region

    for region in (pallas_region("probe", device="cpu", n_steps=8),
                   stream_region(n=4096, device="cpu")):
        assert region.sass is None
        with pytest.raises(au.AuditError, match="no compiled noise"):
            au.sass_text(region, "fp", 4)
        assert derive_body_size(region) == 0


def test_sabotage_reaches_the_static_builds_and_their_path(monkeypatch):
    monkeypatch.setattr(_build, "source_hash", lambda: "h")
    clean = _build.static_lib_path("noise_probes", 1, 4)
    monkeypatch.setenv(_build.SABOTAGE_VAR, "const")
    bad = _build.static_lib_path("noise_probes", 1, 4)
    assert bad != clean and "sabotage" in bad
    assert _build.static_lib_path("noise_probes", 1, 4, sabotage=False) \
        == clean
    assert _build._with_sabotage((), None) == (_build.SABOTAGE_DEFINE,)


# ---------------------------------------------------------------------------
# the fleet's gate and `fleet audit`, on a census injected in place of the
# card's (the plan's regions are the plain versions on the cpu)
# ---------------------------------------------------------------------------

@pytest.fixture
def synth_measure(monkeypatch):
    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")


def _plan(tmp_path, modes=("fp", "mxu")):
    from repro_torch.fleet.plan import SweepPlan, TargetSpec

    plan = SweepPlan(name="audit_probe", store=str(tmp_path / "s.jsonl"),
                     targets=[TargetSpec("pallas", modes, {
                         "kernel": "probe", "sizes": [8]})],
                     reps=2, shards=1, backend="cpu")
    path = str(tmp_path / "plan.json")
    plan.save(path)
    return plan, path


MAKERS = {"intact": kernel, "degraded": lambda k: kernel(k // 2),
          "dead": lambda k: kernel(0)}


def _inject(monkeypatch, verdicts: dict) -> list:
    """Put a census of synthetic SASS in the card's place: each mode of the
    plan audits to ``verdicts[mode]``. Returns the ``skip`` sets the audit
    was called with."""
    import repro_torch.analysis as analysis

    calls = []

    def audit_plan(plan, *, skip=frozenset(), on_error=None, **kw):
        calls.append(set(skip))
        return [au.audit_texts(*(MAKERS[verdicts[m]](k) for k in (0, 4, 12)),
                               region=r, mode=m, target="compute", hint=HINT)
                for r, m in plan.grid() if (r, m) not in skip]

    monkeypatch.setattr(analysis, "audit_plan", audit_plan)
    return calls


def test_gate_refuses_a_dead_pair_before_any_point_is_measured(
        tmp_path, synth_measure, monkeypatch, capsys):
    from repro_torch.fleet.executor import FleetError, run_fleet, run_worker
    from repro_torch.fleet.launchers import LocalLauncher

    _inject(monkeypatch, {"fp": "intact", "mxu": "dead"})
    plan, path = _plan(tmp_path)
    in_process = LocalLauncher(in_process=True)
    with pytest.raises(FleetError, match="audit gate: 1 planned pair"):
        run_fleet(path, launcher=in_process)
    with pytest.raises(FleetError, match="--audit warn"):
        run_worker(plan)
    store = CampaignStore(plan.store, readonly=True)
    assert not store.points and not store.done
    assert {r["verdict"] for r in store.audits.values()} == {"intact", "dead"}
    assert not os.path.exists(plan.fleet_path())
    res = run_fleet(path, audit="warn", launcher=in_process)
    out = capsys.readouterr().out
    assert "--audit warn: measuring anyway" in out
    assert CampaignStore(plan.store, readonly=True).points
    evidence = {e["mode"]: e for e in
                res.reports["pallas_probe_s8"].bottleneck.evidence}
    assert evidence["mxu"]["verdict"] == "dead"
    assert not evidence["mxu"]["supports"] and evidence["fp"]["supports"]


def test_audit_off_never_audits(tmp_path, synth_measure, monkeypatch):
    import repro_torch.analysis as analysis
    from repro_torch.fleet.executor import run_fleet
    from repro_torch.fleet.launchers import LocalLauncher

    def refuse(*a, **kw):
        raise AssertionError("--audit off audited")

    monkeypatch.setattr(analysis, "audit_plan", refuse)
    plan, path = _plan(tmp_path)
    res = run_fleet(path, audit="off", launcher=LocalLauncher(in_process=True))
    assert res.reports and not CampaignStore(plan.store,
                                             readonly=True).audits


def test_a_resumed_fleet_audits_nothing(tmp_path, synth_measure,
                                        monkeypatch):
    from repro_torch.fleet.executor import run_fleet
    from repro_torch.fleet.launchers import LocalLauncher

    calls = _inject(monkeypatch, {"fp": "intact", "mxu": "intact"})
    plan, path = _plan(tmp_path)
    run_fleet(path, launcher=LocalLauncher(in_process=True))
    assert calls == [set()]
    res = run_fleet(path, resume=True, expect_no_measure=True)
    assert calls[-1] == set(plan.grid()) and res.stats.measured == 0
    with open(plan.store) as f:
        assert sum('"kind": "audit"' in line for line in f) == 2


@pytest.mark.parametrize("verdicts,flags,code", [
    ({"fp": "intact", "mxu": "intact"}, [], 0),
    ({"fp": "intact", "mxu": "intact"}, ["--expect-clean"], 0),
    ({"fp": "intact", "mxu": "degraded"}, [], 0),
    ({"fp": "intact", "mxu": "degraded"}, ["--expect-clean"], 1),
    ({"fp": "dead", "mxu": "intact"}, [], 1),
], ids=["clean", "clean-expect", "degraded", "degraded-expect", "dead"])
def test_fleet_audit_exit_codes(tmp_path, monkeypatch, capsys, verdicts,
                                flags, code):
    """The reference's exit codes: 1 on a dead pair; with --expect-clean,
    1 on any pair not intact."""
    from repro_torch.fleet import cli

    _inject(monkeypatch, verdicts)
    _, path = _plan(tmp_path)
    assert cli.main(["audit", "--plan", path, *flags]) == code
    out = capsys.readouterr().out
    n_intact = sum(v == "intact" for v in verdicts.values())
    assert f"== audit verdict: {n_intact}/2 pair(s) intact" in out
    assert out.count("pallas_probe_s8 × ") >= 2


def test_fleet_audit_force_supersedes_records(tmp_path, monkeypatch):
    from repro_torch.fleet import cli

    calls = _inject(monkeypatch, {"fp": "intact", "mxu": "intact"})
    plan, path = _plan(tmp_path)
    assert cli.main(["audit", "--plan", path]) == 0
    assert cli.main(["audit", "--plan", path]) == 0          # from the store
    assert calls[1] == set(plan.grid())
    _inject(monkeypatch, {"fp": "intact", "mxu": "dead"})
    assert cli.main(["audit", "--plan", path]) == 0          # records stand
    assert cli.main(["audit", "--plan", path, "--force"]) == 1
    store = CampaignStore(plan.store, readonly=True)
    assert store.audits[("pallas_probe_s8", "mxu")]["verdict"] == "dead"


def test_fleet_audit_on_the_cpu_backend_is_unauditable(tmp_path, capsys):
    from repro_torch.fleet import cli

    plan, path = _plan(tmp_path)
    assert cli.main(["audit", "--plan", path]) == 0
    assert cli.main(["audit", "--plan", path, "--expect-clean"]) == 1
    out = capsys.readouterr().out
    assert out.count("UNAUDITABLE") == 4 and "0/2 pair(s) intact" in out
    assert not os.path.exists(plan.store)
