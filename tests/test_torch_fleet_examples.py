"""The port's two fleet examples (``examples/torch_fleet_probe.py`` and
``examples/torch_multihost_fleet.py``) run as a user runs them, with
``--backend cpu`` under the synthetic clock (REPRO_SYNTH_MEASURE), each in
its own directory: plan, run, doctor and status; the mock cluster's crash,
retry and heal, and the ssh recipe."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(tmp_path, name):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_SYNTH_MEASURE="1e-3")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name),
         "--backend", "cpu", "--dir", "out"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("name,expected", [
    ("torch_fleet_probe.py",
     ["merge: 2 new segment(s) adopted, 0 already merged",
      "== verdict: COMPLETE",
      "== explain: decision path per region",
      "replay: 0 launched, 0 measured",
      "segments: 1 sealed"]),
    ("torch_multihost_fleet.py",
     ["shard 1 would run on n1",
      "shard 0 attempt 1: mock@mock-host-0 rc=-9",
      "shard 0 attempt 2: mock@mock-host-0 rc=0 measured=1",
      "== verdict: COMPLETE",
      "--launcher ssh --hosts out/hosts.json",
      "manual multi-host recipe"]),
], ids=["fleet_probe", "multihost_fleet"])
def test_example_runs_on_the_cpu(tmp_path, name, expected):
    stdout = _run(tmp_path, name)
    for text in expected:
        assert text in stdout, text
    assert os.path.isdir(tmp_path / "out")
