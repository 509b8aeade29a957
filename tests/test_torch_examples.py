"""The port's four examples (``examples/torch_quickstart.py``,
``torch_probe_train_step.py``, ``torch_serve_lm.py``, ``torch_train_lm.py``)
on the CPU at the small sizes their flags allow:

* each runs as a user runs it (a subprocess with ``--device cpu``), and
  without a card each refuses to run unless given ``--device cpu``;
* serve_lm's function on the reference's ``init(PRNGKey(0))`` weights
  carried across (``convert.lm_params_to_torch``) gives the reference
  engine's greedy tokens for the same 10 requests (f32);
* train_lm's first 8 steps on the reference's state carried across equal
  the reference ``Trainer``'s losses within 1e-5 (f32; the tolerance of
  ``tests/test_torch_train.py``), and after its injected failure every
  replayed step's loss equals, bitwise, that of its first run;
* probe_train_step reports payload = expected for every mode, its
  analytic half read off a dry-run record the module traces once;
* chip_smoke's phase 14 (the examples on the card) parses alone.
"""
import dataclasses
import importlib.util
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro_torch.convert import lm_params_to_torch, train_state_to_torch
from repro_torch.models.model import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")


def _load(name: str, path: str = EXAMPLES):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(path, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(tmp_path, name, *args, timeout=600):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, f"{name}.py"), *args],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=timeout)


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


@pytest.fixture(scope="module")
def dryrun_dir(tmp_path_factory):
    """gemma-2b train_4k on 16 x 16, traced once by the port's dry-run."""
    from repro_torch.launch.dryrun import run_cell

    out = tmp_path_factory.mktemp("dryrun")
    rec = run_cell("gemma_2b", "train_4k", multi_pod=False,
                   out_dir=str(out), verbose=False)
    assert rec["status"] == "ok", rec
    return str(out / "16x16")


# ---------------------------------------------------------------------------
# as a user runs them
# ---------------------------------------------------------------------------

TRAIN_SMALL = ("--dim", "64", "--layers", "1", "--seq", "16", "--batch",
               "2", "--vocab", "256")


def test_quickstart_prints_both_regions_summaries(tmp_path):
    out = _run(tmp_path, "torch_quickstart", "--device", "cpu",
               "--stream-n", "4096", "--haccmk-iters", "200")
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    text = out.stdout
    for line in ("memory-bound kernel (STREAM triad):",
                 "region 'stream_triad'  (|body|=5)",
                 "compute-bound kernel (HACCmk):",
                 "region 'haccmk'  (|body|=30)"):
        assert line in text, line
    for mode in ("fp_add", "l1_ld", "mem_ld"):
        assert len(re.findall(rf"^  {mode} +Abs\^raw=.*payload=100%$", text,
                              re.MULTILINE)) == 2, mode
    assert text.count("  => [") == 2
    labels = re.findall(r"^  => \[(\w+) \|", text, re.MULTILINE)
    reading = text.strip().splitlines()[-1]
    assert reading.startswith(f"reading: STREAM triad -> {labels[0]} ")
    assert f"; HACCmk -> {labels[1]} " in reading


def test_probe_train_step_payload_equals_expected(tmp_path, dryrun_dir):
    out = _run(tmp_path, "torch_probe_train_step", "--device", "cpu",
               "--seq", "16", "--batch", "2", "--reps", "2", "--dryrun-dir",
               dryrun_dir, "--store", "pred.jsonl")
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    text = out.stdout
    payloads = dict(re.findall(r"^  (\w+) +Abs\^raw=.*payload=(\d+/\d+)",
                               text, re.MULTILINE))
    assert set(payloads) == {"fp_add32", "mxu_fma128", "vmem_ld",
                             "hbm_stream"}
    for mode, frac in payloads.items():
        got, want = frac.split("/")
        assert got == want and int(want) > 0, (mode, frac)
    assert "tracing the cell" not in text           # the record was read
    assert "== analytic probe: gemma_2b train_4k [16x16]" in text
    assert "TPU" not in text
    assert re.search(r"^The compute term dominates the full-scale cell "
                     r"\(Tc=2526\.2 ms, Tm=1895\.9 ms, Ti=69\.2 ms\) -> "
                     r"predicted \[mixed\]", text, re.MULTILINE), text


def test_serve_lm_serves_every_request(tmp_path):
    out = _run(tmp_path, "torch_serve_lm", "--device", "cpu")
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert re.search(r"^served 10 requests on 4 slots: 240 tokens in ",
                     out.stdout, re.MULTILINE), out.stdout
    assert len(re.findall(r"^  req\d+: prompt\[:4\]=", out.stdout,
                          re.MULTILINE)) == 3


def test_train_lm_replays_after_the_failure(tmp_path):
    out = _run(tmp_path, "torch_train_lm", "--device", "cpu", "--steps",
               "12", "--ckpt-every", "4", *TRAIN_SMALL)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    text = out.stdout
    assert "model: 1L d=64 " in text
    assert "*** simulated node failure at step 6" in text
    assert "over 14 executed steps (incl. replays)" in text
    assert "replayed steps 4-5: 2/2 losses bitwise equal" in text
    assert os.path.isdir(tmp_path / "experiments" / "ckpt_torch" / "train_lm")


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_probe_train_step",
                                  "torch_serve_lm", "torch_train_lm"])
def test_an_example_refuses_without_a_card(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(tmp_path, name, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert "Abs^raw" not in out.stdout and "served" not in out.stdout
    assert "loss" not in out.stdout


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def test_serve_lm_tokens_equal_the_reference_engine():
    """In f32, as ``tests/test_torch_serve.py`` compares the engines: in
    the smoke config's bf16 the two frameworks round differently, and a
    near-tie flips one greedy token 21 tokens into request 1."""
    from repro import configs as ref_configs
    from repro.models.model import build as ref_build
    from repro.serve import ServeEngine as RefEngine
    from repro_torch import configs

    ex = _load("torch_serve_lm")
    rapi = ref_build(_f32(ref_configs.get_smoke_config(ex.ARCH)))
    rparams = rapi.init(jax.random.PRNGKey(0))
    api = build(_f32(configs.get_smoke_config(ex.ARCH)))
    params = lm_params_to_torch(api.cfg, jax.tree.map(np.asarray, rparams))
    requests, _ = ex.serve(api, params)
    engine = RefEngine(rapi, rparams, n_slots=4, max_seq=128,
                       temperature=0.0)
    want = [engine.submit(p, max_new=24)
            for p in ex.prompts(api.cfg.vocab_size)]
    engine.run()
    assert all(r.done for r in requests) and all(r.done for r in want)
    assert [r.prompt for r in requests] == [r.prompt for r in want]
    assert [r.out for r in requests] == [r.out for r in want]


def _train_pair():
    from repro import configs as ref_configs

    ex = _load("torch_train_lm")
    cfg = _f32(ex.example_config(dim=64, layers=1, vocab=256))
    rcfg = dataclasses.replace(
        ref_configs.get_config("gemma_2b"), **{
            f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(cfg)
            if f.name in ("name", "n_layers", "d_model", "n_heads",
                          "n_kv_heads", "head_dim", "d_ff", "vocab_size",
                          "param_dtype", "compute_dtype")})
    return ex, cfg, rcfg


def test_train_lm_first_steps_equal_the_reference_trainer(tmp_path):
    from repro.configs.base import ShapeConfig as RefShape
    from repro.configs.base import TrainConfig as RefTrain
    from repro.data.pipeline import SyntheticPipeline as RefPipe
    from repro.models.model import build as ref_build
    from repro.train import optimizer as ropt
    from repro.train.trainer import Trainer as RefTrainer
    from repro.train.trainer import TrainState as RefState

    ex, cfg, rcfg = _train_pair()
    rapi = ref_build(rcfg)
    rp = rapi.init(jax.random.PRNGKey(0))
    rstate = RefState(params=rp, opt=ropt.adamw_init(rp))
    state = train_state_to_torch(cfg, jax.tree.map(np.asarray, rstate))
    _, hist = ex.train(cfg, steps=8, seq=16, batch=2,
                       ckpt_dir=str(tmp_path / "ck"), inject_failure=False,
                       device="cpu", state=state)
    rtrainer = RefTrainer(rapi, RefTrain(lr=1e-3, warmup_steps=20,
                                         total_steps=8, microbatches=1,
                                         ckpt_every=50))
    _, rhist = rtrainer.run(rstate, RefPipe(rcfg, RefShape("ex", "train", 16,
                                                           2), task="lcg"),
                            steps=8)
    assert [h["step"] for h in hist] == [h["step"] for h in rhist] \
        == list(range(8))
    for h, rh in zip(hist, rhist):
        assert h["loss"] == pytest.approx(float(rh["loss"]), rel=1e-5)
        assert h["grad_norm"] == pytest.approx(float(rh["grad_norm"]),
                                               rel=1e-5)


def test_train_lm_replayed_steps_are_bitwise_their_first_run(tmp_path):
    """12 steps with a checkpoint every 4: the failure at step 6 restores
    the step-4 checkpoint, so steps 4 and 5 run twice."""
    ex, cfg, _ = _train_pair()
    _, hist = ex.train(cfg, steps=12, seq=16, batch=2, ckpt_every=4,
                       ckpt_dir=str(tmp_path / "ck"), device="cpu")
    assert [h["step"] for h in hist] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8,
                                         9, 10, 11]
    again = ex.replays(hist)
    assert [step for step, _, _ in again] == [4, 5]
    for step, first, replay in again:
        assert np.float64(first).tobytes() == np.float64(replay).tobytes(), \
            step


def test_train_lm_removes_only_checkpoints_from_its_directory(tmp_path):
    """``--ckpt-dir`` may be a directory that holds the user's own files:
    train removes only what a ``CheckpointManager`` writes there
    (``step_<N>``, ``step_<N>.tmp``). A stale checkpoint of a later step
    is removed, so the failure at step 6 restores this run's step-4
    checkpoint and replays 4 and 5 (restored, step 40 would end the run);
    a foreign file, a foreign subdirectory and a name that only looks like
    a checkpoint survive."""
    ex, cfg, _ = _train_pair()
    ck = tmp_path / "ck"
    ex.train(cfg, steps=4, seq=16, batch=2, ckpt_every=4, ckpt_dir=str(ck),
             inject_failure=False, device="cpu")
    os.rename(ck / "step_4", ck / "step_40")
    (ck / "step_7.tmp").mkdir()
    (ck / "notes").mkdir()
    (ck / "notes" / "a.txt").write_text("mine")
    (ck / "results.csv").write_text("1,2\n")
    (ck / "step_final").write_text("not a checkpoint")
    _, hist = ex.train(cfg, steps=12, seq=16, batch=2, ckpt_every=4,
                       ckpt_dir=str(ck), device="cpu")
    assert [h["step"] for h in hist] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8,
                                         9, 10, 11]
    assert (ck / "notes" / "a.txt").read_text() == "mine"
    assert (ck / "results.csv").read_text() == "1,2\n"
    assert (ck / "step_final").read_text() == "not a checkpoint"
    assert sorted(p.name for p in ck.iterdir() if p.name.startswith(
        "step_") and p.name != "step_final") == ["step_12", "step_8"]


# ---------------------------------------------------------------------------
# chip_smoke's phase 14
# ---------------------------------------------------------------------------

def test_chip_smoke_runs_phase_14_alone():
    chip = _load("chip_smoke", ROOT)
    assert chip.parse_phases("14") == [1, 14]
    assert 14 in chip.parse_phases(None)
    assert chip.parse_phases("13-14") == [1, 13, 14]
    assert chip.EXAMPLE_TRAIN_REPLAYED == tuple(range(50, 75))
