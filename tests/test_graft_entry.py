"""``dryrun_multichip`` on virtual CPU devices, and its refusal to run on
fewer devices than asked (it never switches platform on its own)."""

import os
import subprocess
import sys

import pytest

from conftest import REPO_ROOT


@pytest.mark.parametrize("have", [4, 1])
def test_dryrun_multichip_4(have):
    env = dict(
        os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO_ROOT),
        XLA_FLAGS=f"--xla_force_host_platform_device_count={have}",
    )
    proc = subprocess.run(
        [sys.executable, "-c", "import __graft_entry__ as g; g.dryrun_multichip(4)"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    if have == 4:
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "dryrun_multichip(4): OK" in proc.stdout
    else:
        assert proc.returncode != 0
        assert "needs 4 devices; JAX has 1 (cpu)" in proc.stderr
