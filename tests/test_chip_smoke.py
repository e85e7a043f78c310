"""`chip_smoke.py`: refuses to run without a GPU or outside a checkout,
and runs its single-card phases end to end where there is a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _run(cwd, script, env, timeout):
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_fails_on_cpu_naming_the_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = _run(ROOT, SCRIPT, env, 300)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_fails_outside_a_checkout(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = _run(tmp_path, str(tmp_path / "chip_smoke.py"), env, 300)
    assert proc.returncode != 0
    assert "cice4_tpu not found" in proc.stderr
    assert '"ok"' not in proc.stdout


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_card):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = _run(ROOT, SCRIPT, env, 1500)
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True
    assert last["device"]["platform"] == "gpu"
    assert last["device"]["count"] == 1
