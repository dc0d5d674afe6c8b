"""GPU tier: `chip_smoke.py` on an NVIDIA GPU, in a child process (the
test process itself is pinned to the CPU by conftest.py).

Run on a machine with a GPU:  python -m pytest tests/test_gpu.py -m gpu
Skips where `nvidia-smi` lists no GPU.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    smi = shutil.which("nvidia-smi")
    listed = smi and subprocess.run(
        [smi, "-L"], capture_output=True, text=True, timeout=60).stdout
    if not listed or "GPU" not in listed:
        pytest.skip("no NVIDIA GPU listed by nvidia-smi")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
