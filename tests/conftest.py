"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices (set before any jax
import) so multi-device sharding paths are testable without accelerators,
unless the caller sets ``JAX_PLATFORMS``. Tests marked ``gpu`` need an
NVIDIA GPU and skip elsewhere; run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` (``chip_smoke.py``
does).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

REFERENCE = Path("/root/reference")

import subprocess

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (JAX_PLATFORMS=cuda); skips on other platforms",
    )


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise.

    Decided here, at run time, never at import: every xdist worker must
    collect the same tests."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            f"needs an NVIDIA GPU (JAX platform is {dev.platform}); run "
            "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/"
        )
    return dev


@pytest.fixture(scope="session")
def reference_scripts():
    """Path to the reference implementation's scripts dir (differential tests)."""
    p = REFERENCE / "scripts"
    if not p.is_dir():
        pytest.skip("reference implementation not available")
    return p


def run_cli(cmd, out_path=None, hashseed=None, env_extra=None):
    """Run a pipeline command (ours or reference) with repo on PYTHONPATH."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT)
    if hashseed is not None:
        env["PYTHONHASHSEED"] = hashseed
    if env_extra:
        env.update(env_extra)
    if out_path is not None:
        with open(out_path, "w") as out:
            proc = subprocess.run(cmd, stdout=out, stderr=subprocess.PIPE, env=env, text=True)
    else:
        proc = subprocess.run(cmd, capture_output=True, env=env, text=True)
    assert proc.returncode == 0, getattr(proc, "stderr", "")[-2000:]
    return proc


@pytest.fixture(scope="session")
def example_graph(tmp_path_factory):
    """example/4 annotated pangenome built once per session by OUR build."""
    example = REFERENCE / "example"
    if not example.is_dir():
        pytest.skip("example data not available")
    wd = tmp_path_factory.mktemp("ex4graph")
    run_cli(
        [sys.executable, "-m", "pantas_tpu", "build",
         str(example / "4.fa"), str(example / "4.gtf"), str(example / "4.vcf.gz"),
         "-o", str(wd)],
    )
    return wd / "pantranscriptome-annotated.gfa"
