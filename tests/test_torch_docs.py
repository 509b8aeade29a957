"""Guards of the port's documentation and CPU workflow:

* ``docs/port.md`` names every ``.py`` under ``src/repro/`` and under
  ``src/repro_torch/`` (its module map cannot go stale) and quotes every
  ``examples/torch_*.py``;
* the port's counterparts of ``tests/test_docstrings.py``'s ten modules
  carry a docstring on every public symbol, and every option of the
  port's probe and fleet parsers has help text;
* ``.github/workflows/torch-port.yml`` parses, every ``python -m
  repro_torch.…`` module it quotes exists and its ``--help`` exits 0, and
  every ``examples/…`` script it runs exists.
"""
import glob
import importlib
import inspect
import os
import re
import subprocess
import sys

import pytest
import yaml
from test_docstrings import _actions, _public_methods, _public_symbols

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PAGE = os.path.join(ROOT, "docs", "port.md")
WORKFLOW = os.path.join(ROOT, ".github", "workflows", "torch-port.yml")


def _py_files(package: str) -> list:
    base = os.path.join(ROOT, "src", package)
    return sorted(os.path.relpath(p, ROOT) for p in glob.glob(
        os.path.join(base, "**", "*.py"), recursive=True))


def _backticked() -> set:
    return set(re.findall(r"`([^`\n]+)`", open(PORT_PAGE).read()))


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_the_module_map_names_every_module(package):
    files = _py_files(package)
    assert len(files) > 50
    missing = [f for f in files if f not in _backticked()]
    assert not missing, f"docs/port.md does not name {missing}"


def test_the_port_page_quotes_every_port_example():
    examples = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
        os.path.join(ROOT, "examples", "torch_*.py")))
    assert len(examples) >= 6
    text = open(PORT_PAGE).read()
    missing = [e for e in examples
               if f"python {e}" not in text or f"`{e}`" not in text]
    assert not missing, f"docs/port.md does not quote {missing}"


# ---------------------------------------------------------------------------
# docstrings and help text (the reference's tests/test_docstrings.py on the
# port's counterparts)
# ---------------------------------------------------------------------------

PUBLIC_MODULES = [
    "repro_torch.fleet",
    "repro_torch.fleet.plan",
    "repro_torch.fleet.executor",
    "repro_torch.fleet.launchers",
    "repro_torch.fleet.cli",
    "repro_torch.core.campaign",
    "repro_torch.core.calibration",
    "repro_torch.core.strategy",
    "repro_torch.kernels.region",
    "repro_torch.launch.probe",
]


@pytest.mark.parametrize("modname", PUBLIC_MODULES)
def test_the_port_api_is_documented(modname):
    mod = importlib.import_module(modname)
    assert (mod.__doc__ or "").strip(), f"{modname} has no module docstring"
    missing = []
    for name, obj in _public_symbols(mod):
        if not (obj.__doc__ or "").strip():
            missing.append(f"{modname}.{name}")
        if inspect.isclass(obj):
            for mname, meth in _public_methods(obj):
                if not (getattr(meth, "__doc__", "") or "").strip():
                    missing.append(f"{modname}.{name}.{mname}")
    assert not missing, ("public symbols without a docstring: "
                         + ", ".join(sorted(missing)))


@pytest.mark.parametrize("modname", ["repro_torch.launch.probe",
                                     "repro_torch.fleet.cli"])
def test_the_port_cli_help_text_is_complete(modname):
    parser = importlib.import_module(modname).build_parser()
    bare = [a.dest for a in _actions(parser) if not a.help]
    assert not bare, f"{modname} options without help text: {bare}"


# ---------------------------------------------------------------------------
# the CPU workflow
# ---------------------------------------------------------------------------

def _workflow_runs() -> str:
    wf = yaml.safe_load(open(WORKFLOW))
    return "\n".join(step["run"] for job in wf["jobs"].values()
                     for step in job["steps"] if "run" in step)


WF_MODULES = sorted(set(re.findall(r"python -m (repro_torch[\w.]*)",
                                   _workflow_runs())))
WF_EXAMPLES = sorted(set(re.findall(r"(examples/[\w/.-]+\.py)",
                                    _workflow_runs())))


def test_the_workflow_mirrors_the_reference_jobs():
    wf = yaml.safe_load(open(WORKFLOW))
    assert set(wf["jobs"]) == {"tests", "probe-smoke", "fleet-smoke",
                               "store-smoke", "quality-smoke",
                               "calibrate-smoke", "serve-smoke", "examples"}
    for name, job in wf["jobs"].items():
        setup = [s for s in job["steps"] if "with" in s]
        assert setup[0]["with"]["python-version"] == "3.12", name
        install = next(s["run"] for s in job["steps"]
                       if s.get("name") == "Install deps")
        assert "download.pytorch.org/whl/cpu" in install, name
        assert "requirements-dev.txt" in install, name
    runs = _workflow_runs()
    assert "pytest -q tests/test_torch_*.py" in runs
    assert "python -m repro." not in runs       # the reference runs in ci.yml
    assert len(WF_EXAMPLES) == 6


@pytest.mark.parametrize("module", WF_MODULES)
def test_a_workflow_module_builds_its_parser(module):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", module, "--help"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "usage:" in out.stdout


@pytest.mark.parametrize("script", WF_EXAMPLES)
def test_a_workflow_example_exists(script):
    assert os.path.isfile(os.path.join(ROOT, script)), script
