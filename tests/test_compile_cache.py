"""Persistent compilation cache placement + the single-device scatter step.

With ``JAX_COMPILATION_CACHE_DIR`` set, JAX's own reading of it stands and
no other directory is set; otherwise the cache goes to the fixed
``<repo>/.jax_cache``, whatever the working directory or ``HOME``.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from conftest import REPO_ROOT
from fixtures_micro import write_micro

from pantas_tpu.compile_cache import DEFAULT_DIR, enable_persistent_cache
from pantas_tpu.coverage.device import DeviceCoverage
from pantas_tpu.graph.compiler import compile_gfa
from pantas_tpu.parallel.mesh import scatter_step


def test_enable_persistent_cache_sets_config(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        d = enable_persistent_cache()
        assert d == DEFAULT_DIR == str(REPO_ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 0
        assert jax.config.jax_persistent_cache_min_entry_size_bytes == -1
        # idempotent
        assert enable_persistent_cache() == d
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("env_dir", [True, False], ids=["env", "default"])
def test_cache_dir_choice(tmp_path, env_dir):
    """A fresh process, run from elsewhere with another HOME: the env
    variable wins when set, else the fixed in-checkout path."""
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), HOME=str(tmp_path))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    code = (
        "import json, jax\n"
        "from pantas_tpu.compile_cache import enable_persistent_cache\n"
        "d = enable_persistent_cache()\n"
        "print(json.dumps([d, jax.config.jax_compilation_cache_dir]))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    got, cfg = json.loads(proc.stdout.strip().splitlines()[-1])
    want = str(tmp_path / "cc") if env_dir else str(REPO_ROOT / ".jax_cache")
    assert got == cfg == want


def test_cpu_default_skips_race(tmp_path):
    # the single-device engine steps with the one donated XLA scatter, and
    # accumulation into the power-of-2 padded vector is exact
    gfa, _ = write_micro(tmp_path)
    t = compile_gfa(gfa)
    assert jax.default_backend() == "cpu"
    cov = DeviceCoverage(t)
    assert cov._step is scatter_step
    assert cov._padded_slots >= t.total_slots
    assert cov._padded_slots & (cov._padded_slots - 1) == 0

    cov.add_slots(np.array([0, 1, 1, -1], dtype=np.int32), pad_to=8)
    out = cov.result()
    assert len(out) == t.total_slots
    assert out[0] == 1 and out[1] == 2 and out.sum() == 3
