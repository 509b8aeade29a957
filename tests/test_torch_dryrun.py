"""The port's dry-run (``launch/dryrun.py``, ``launch/steps.py``), its
report (``roofline/report.py``) and the probe's ``--analytic`` route on
the CPU:

* ``run_cell`` on the 16 x 16 mesh (256 fake ranks) for gemma-2b
  ``decode_32k`` writes ``status: ok`` with every key that ``render`` and
  ``analytic_probe`` read, and its argument bytes are the rank-local
  shard bytes of the params and cache (``Layout``: each dim split by its
  spec's axes) plus the rank's token rows and the position, exactly; the
  same cell on 2 x 16 x 16 (512 fake ranks) holds half the cache;
* ``long_500k`` cells of the full-attention archs skip with the
  reference's record, letter for letter; a cell that fails writes
  ``status: fail`` and the CLI exits 1;
* the CLI prints the reference's ``OK``/``SKIP``/``FAIL`` lines and tail;
* a one-rank cell traced on meta runs the same ops (name, shapes and
  dtypes, in order, collectives included), with the same argument, temp
  and output bytes, as the same program run on CPU tensors;
* the analytic probe persists ``pred`` records, replays them with
  ``--expect-no-measure``, and recomputes when ``tol`` changes; fed a
  ``HardwareConfig`` with the reference's field values (made here, never
  in the port), its records equal the reference's ``analytic_probe``
  records on the record ``tests/test_system.py`` uses.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro import configs as rc
from repro_torch import configs
from repro_torch.configs import MeshConfig, ShapeConfig
from repro_torch.launch import dryrun, probe, steps
from repro_torch.models.model import build
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.fake import fake_world
from repro_torch.roofline import report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    recs = {mp: dryrun.run_cell("gemma_2b", "decode_32k", multi_pod=mp,
                                out_dir=out, verbose=False)
            for mp in (False, True)}
    return out, recs


def _local_bytes(shape, dtype, spec, sizes) -> int:
    n = 1
    for i, d in enumerate(shape):
        split = 1
        if i < len(spec):
            for a in sh.entry_axes(spec[i]):
                split *= sizes[a]
        assert d % split == 0
        n *= d // split
    return n * torch.tensor([], dtype=dtype).element_size()


def _want_argument_bytes(multi_pod: bool) -> int:
    """The rank-local bytes of gemma-2b's decode_32k arguments, from the
    specs on an abstract mesh and the full shapes (no trace)."""
    from repro_torch.configs.base import MULTI_POD, SINGLE_POD

    mcfg = MULTI_POD if multi_pod else SINGLE_POD
    mesh = sh.AbstractMesh(mcfg.shape, mcfg.axes)
    sizes = sh.mesh_axis_sizes(mesh)
    cfg = configs.get_config("gemma_2b")
    api = build(cfg)
    shape = configs.SHAPES["decode_32k"]
    params = api.init(0, "meta")
    cache = api.decode_init(params, {"tokens": torch.zeros(
        (shape.global_batch, 1), dtype=torch.int32), "max_seq":
        shape.seq_len})
    logical = api.param_spec()
    total = 0
    for n, p in params.named_parameters():
        spec = sh.resolve(logical[n], tuple(p.shape), mesh)
        total += _local_bytes(p.shape, p.dtype, spec, sizes)
    clog = api.cache_spec()["kv"]
    for n, t in cache["kv"].items():
        spec = sh.resolve(clog[n], tuple(t.shape), mesh)
        total += _local_bytes(t.shape, t.dtype, spec, sizes)
    tok = sh.resolve(("batch", None), (shape.global_batch, 1), mesh)
    total += _local_bytes((shape.global_batch, 1), torch.int32, tok, sizes)
    return total + 4                                   # pos, int32


@pytest.mark.parametrize("multi_pod", (False, True),
                         ids=("16x16", "2x16x16"))
def test_a_production_mesh_record(records, multi_pod):
    out, recs = records
    rec = recs[multi_pod]
    mesh = "2x16x16" if multi_pod else "16x16"
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["kind"] == "decode" and rec["mesh"] == mesh
    rf = rec["roofline"]
    for key in ("t_compute", "t_memory", "t_ici", "dominant",
                "model_flops_total", "n_chips", "hbm_bytes_per_chip",
                "useful_ratio", "peak_flops"):
        assert key in rf, key
    assert rf["n_chips"] == (512 if multi_pod else 256)
    assert min(rf["t_compute"], rf["t_memory"], rf["t_ici"]) > 0
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == _want_argument_bytes(multi_pod)
    assert mem["generated_code_size_in_bytes"] is None
    assert 0 < mem["alias_size_in_bytes"] < mem["argument_size_in_bytes"]
    assert rec["cost"]["flops"] == rf["flops_per_chip"] > 0
    with open(os.path.join(out, mesh, "gemma_2b_decode_32k.json")) as f:
        assert json.load(f) == json.loads(json.dumps(rec, default=str))
    # the pod axis halves the cache's rows a rank holds
    if multi_pod:
        single = recs[False]["memory"]["alias_size_in_bytes"]
        assert mem["alias_size_in_bytes"] * 2 == single


def test_the_report_renders_the_records(records):
    out, _ = records
    table = report.render(os.path.join(out, "16x16"))
    row = [ln for ln in table.splitlines() if ln.startswith("| gemma_2b")]
    assert len(row) == 1 and "| decode_32k |" in row[0]
    assert "memory" in row[0] and "bw " in row[0]


SKIPPED = [a for a in rc.ARCHS
           if not rc.shape_applicable(rc.get_config(a),
                                      rc.SHAPES["long_500k"])[0]]


@pytest.mark.parametrize("arch", SKIPPED)
def test_long_500k_skips_with_the_references_record(tmp_path, arch):
    rec = dryrun.run_cell(arch, "long_500k", multi_pod=False,
                          out_dir=str(tmp_path), verbose=False)
    reason = rc.shape_applicable(rc.get_config(arch),
                                 rc.SHAPES["long_500k"])[1]
    want = {"arch": arch, "shape": "long_500k", "mesh": "16x16", "tag": "",
            "status": "skip", "reason": reason}
    assert rec == want
    with open(tmp_path / "16x16" / f"{arch}_long_500k.json") as f:
        assert json.load(f) == want


def test_a_failing_cell_is_recorded_and_fails_the_cli(tmp_path,
                                                      monkeypatch, capsys):
    rec = dryrun.run_cell("gemma_2b", "decode_32k", multi_pod=False,
                          out_dir=str(tmp_path), verbose=False,
                          overrides={"family": "nope"})
    assert rec["status"] == "fail"
    assert "unknown model family" in rec["error"]
    with open(tmp_path / "16x16" / "gemma_2b_decode_32k.json") as f:
        assert json.load(f)["status"] == "fail"
    run = dryrun.run_cell
    monkeypatch.setattr(dryrun, "run_cell", lambda *a, **kw: run(
        *a, **dict(kw, overrides={"family": "nope"})))
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert exc.value.code == 1
    printed = capsys.readouterr().out
    assert printed.startswith("FAIL gemma_2b_decode_32k [16x16]: ValueError")
    assert "dry-run complete: 0 ok, 0 skip, 1 fail" in printed


def test_the_cli_prints_skip_lines(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma-2b", "--shape", "long_500k", "--out", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("SKIP gemma_2b_long_500k [16x16]: ")
    assert "dry-run complete: 0 ok, 1 skip, 0 fail" in out.stdout


def test_the_cli_writes_an_ok_record_and_roofline_line(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-780m", "--shape", "decode_32k", "--out", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("OK   mamba2_780m_decode_32k [16x16] ")
    assert "Tc=" in lines[1] and "Ti=" in lines[1]
    assert lines[-1] == "dry-run complete: 1 ok, 0 skip, 0 fail"
    assert (tmp_path / "16x16" / "mamba2_780m_decode_32k.json").exists()


@pytest.mark.parametrize("arch", ("gemma-2b", "qwen3-moe-30b-a3b",
                                  "mamba2-780m"))
def test_a_meta_trace_runs_the_ops_of_a_real_run(arch):
    api = build(configs.get_smoke_config(arch))
    cells = {"train": lambda m, d: steps.train_cell(
                 api, ShapeConfig("t", "train", 32, 4), m, microbatches=2,
                 scan_group=1, device=d),
             "prefill": lambda m, d: steps.prefill_cell(
                 api, ShapeConfig("p", "prefill", 32, 4), m, device=d),
             "decode": lambda m, d: steps.decode_cell(
                 api, ShapeConfig("d", "decode", 64, 4), m, device=d)}
    got = {}
    for device in ("meta", "cpu"):
        with fake_world(1):
            mesh = sh.make_mesh_from_config(
                MeshConfig((1, 1), ("data", "model")), "cpu")
            for kind, cell in cells.items():
                prog = cell(mesh, device)
                trace, mem, cost = dryrun.trace_program(prog)
                got[(device, kind)] = (trace.signatures(), mem, cost)
    for kind in cells:
        meta, cpu = got[("meta", kind)], got[("cpu", kind)]
        assert meta[0] == cpu[0], kind
        assert any(s[0].startswith("c10d.") for s in meta[0]) \
            == (kind == "train")
        assert meta[1] == cpu[1] and meta[2] == cpu[2], kind


def _cell_record(tmp_path):
    """The record tests/test_system.py hands the reference's probe."""
    rec = {"status": "ok", "mesh": "16x16",
           "roofline": {"t_compute": 2e-3, "t_memory": 8e-3, "t_ici": 1e-3,
                        "dominant": "memory"}}
    d = tmp_path / "16x16"
    d.mkdir()
    with open(d / "gemma_2b_train_4k.json", "w") as f:
        json.dump(rec, f)
    return str(d)


def test_the_analytic_probe_persists_and_replays(tmp_path, records):
    out, _ = records
    store = str(tmp_path / "pred.jsonl")
    args = ["--analytic", "--arch", "gemma-2b", "--shape", "decode_32k",
            "--dryrun-dir", os.path.join(out, "16x16"), "--store", store]
    rep, stats = probe.main(args)
    assert stats.measured > 0 and rep.bottleneck is not None
    _, again = probe.main(args + ["--expect-no-measure"])
    assert again.measured == 0 and again.cached == stats.measured
    with pytest.raises(SystemExit, match="expect-no-measure"):
        probe.main(args + ["--tol", "0.02", "--expect-no-measure"])
    for bad in (["--pallas", "probe"], ["--serve"]):
        with pytest.raises(SystemExit, match="--analytic"):
            probe.main(args + bad)
    with pytest.raises(SystemExit, match="--shard applies"):
        probe.main(args + ["--shard", "0/2"])


def test_the_analytic_records_equal_the_references(tmp_path):
    from repro.configs.base import TPU_V5E
    from repro.launch.probe import analytic_probe as ref_probe
    from repro_torch.configs.base import HardwareConfig

    d = _cell_record(tmp_path)
    modes = ["fp_add32", "mxu_fma128", "vmem_ld", "hbm_stream"]
    ref_store = str(tmp_path / "r.jsonl")
    port_store = str(tmp_path / "p.jsonl")
    ref_probe("gemma-2b", "train_4k", d, modes, tol=0.05, store=ref_store)
    hw = HardwareConfig(**dataclasses.asdict(TPU_V5E))
    rep, _ = probe.analytic_probe("gemma-2b", "train_4k", d, modes,
                                  tol=0.05, store=port_store, hw=hw)
    with open(ref_store) as f:
        want = [json.loads(ln) for ln in f if ln.strip()]
    with open(port_store) as f:
        got = [json.loads(ln) for ln in f if ln.strip()]
    preds = [r for r in want if r.get("kind") == "pred"]
    assert len(preds) == len(modes)
    assert [r for r in got if r.get("kind") == "pred"] == preds
    _, again = probe.analytic_probe("gemma-2b", "train_4k", d, modes,
                                    tol=0.05, store=ref_store, hw=hw,
                                    expect_no_measure=True)
    assert again.measured == 0
    assert math.isfinite(rep.results["hbm_stream"].fit.k1)
