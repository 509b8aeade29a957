"""The port stands alone: no module under ``src/repro_torch/`` and not
``chip_smoke.py`` imports jax, jaxlib or the reference package; importing
the port's entry point loads no jax; the CLI refuses to run without a card
unless asked for the CPU; ``chip_smoke.py`` fails, printing no result,
without a card or outside a checkout."""
import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(glob.glob(os.path.join(ROOT, "src", "repro_torch", "**",
                                           "*.py"), recursive=True))
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize(
    "path", PORT_FILES + [os.path.join(ROOT, "chip_smoke.py")],
    ids=[os.path.relpath(p, ROOT) for p in PORT_FILES] + ["chip_smoke.py"])
def test_no_jax_or_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_scan_sees_the_whole_package():
    names = {os.path.relpath(p, ROOT) for p in PORT_FILES}
    assert "src/repro_torch/launch/probe.py" in names
    assert "src/repro_torch/kernels/spmv_ell/kernel.py" in names
    assert "src/repro_torch/fleet/executor.py" in names
    assert "src/repro_torch/kernels/flash_attention/kernel.py" in names
    assert "src/repro_torch/core/injector.py" in names
    assert "src/repro_torch/models/attention.py" in names
    assert "src/repro_torch/serve/engine.py" in names
    assert "src/repro_torch/launch/serve.py" in names
    assert len(PORT_FILES) >= 15


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return env


BLOCKED_IMPORT = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):
            raise ImportError(f'{name} is blocked')
        return None
sys.meta_path.insert(0, _Block())
"""

SPINE_MODULES = ("repro_torch.fleet", "repro_torch.fleet.__main__",
                 "repro_torch.fleet.cli", "repro_torch.fleet.executor",
                 "repro_torch.fleet.launchers", "repro_torch.fleet.plan",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.flash_attention.kernel",
                 "repro_torch.kernels.flash_attention.ref",
                 "repro_torch.launch.probe", "repro_torch.core.campaign")


def test_fleet_and_attention_import_with_jax_and_reference_blocked():
    code = (BLOCKED_IMPORT
            + "import importlib\n"
            + "".join(f"importlib.import_module({m!r})\n"
                      for m in SPINE_MODULES)
            + "from repro_torch.fleet.cli import build_parser\n"
            + "build_parser().parse_args(['status', '--plan', 'p.json'])\n")
    subprocess.run([sys.executable, "-c", code], env=_env(), check=True,
                   timeout=120)


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.launch.probe, repro_torch.kernels.region, "
            "repro_torch.core.campaign, repro_torch.convert\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], env=_env(), check=True,
                   timeout=120)


def test_cli_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.probe", "--pallas", "probe",
         "--pallas-n", "8", "--store", str(tmp_path / "s.jsonl")],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not (tmp_path / "s.jsonl").exists()


def test_cli_runs_on_the_cpu_when_asked(tmp_path):
    store = str(tmp_path / "s.jsonl")
    args = [sys.executable, "-m", "repro_torch.launch.probe", "--pallas",
            "probe", "--pallas-n", "8", "--modes", "fp", "--reps", "2",
            "--store", store, "--device", "cpu"]
    first = subprocess.run(args, env=_env(), capture_output=True, text=True,
                           timeout=300, check=True)
    assert "=> [" in first.stdout and "points measured" in first.stdout
    again = subprocess.run(args + ["--expect-no-measure"], env=_env(),
                           capture_output=True, text=True, timeout=300)
    assert again.returncode == 0, again.stderr
    assert "[0 points measured," in again.stdout


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_fails_without_card_or_checkout(tmp_path, alone):
    if torch.cuda.is_available() and not alone:
        pytest.skip("a card is present")
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
