"""Device paths on an NVIDIA GPU (marked ``gpu``; they skip elsewhere).

Run on the card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``;
``chip_smoke.py`` runs them after its phases. Everything on these paths is
int32 or bitset arithmetic, so every comparison is exact.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fixtures_call import write_call_fixtures
from fixtures_micro import write_micro

pytestmark = pytest.mark.gpu


def test_gpu_scatter_matches_bincount(gpu):
    """The augment step compiled for the card, at a 16M-slot width with
    1M-index batches, padding included, lands on the GPU and is exact."""
    from pantas_tpu.parallel.mesh import scatter_step

    width, batch = 1 << 24, 1 << 20
    rng = np.random.default_rng(0)
    counts = jnp.zeros((width,), jnp.int32)
    expect = np.zeros(width, dtype=np.int64)
    for b in range(4):
        idx = rng.integers(-1, width, size=batch, dtype=np.int32)
        if b == 3:
            idx[batch // 2:] = -1
        expect += np.bincount(idx[idx >= 0], minlength=width)
        counts = scatter_step(counts, jnp.asarray(idx))
    assert counts.devices() == {gpu}
    assert np.array_equal(np.asarray(counts), expect.astype(np.int32))


def test_gpu_device_augment_matches_host(gpu, tmp_path):
    from pantas_tpu.coverage import augment_gfa
    from pantas_tpu.coverage.device import augment_gfa_device_native

    gfa, gaf = write_micro(tmp_path)
    big = tmp_path / "big.gaf"
    big.write_text(open(gaf).read() * 200)
    host, dev = io.StringIO(), io.StringIO()
    augment_gfa(str(big), gfa, out=host, log=io.StringIO())
    augment_gfa_device_native(str(big), gfa, out=dev, flush_every=256, log=io.StringIO())
    assert dev.getvalue() == host.getvalue()


def test_gpu_device_call_matches_host(gpu, tmp_path):
    from pantas_tpu.events import CallOptions, call_events
    from pantas_tpu.events.batched import call_events_device

    paths = write_call_fixtures(tmp_path)
    for name in ("splice", "cassette"):
        gfa, gtf = paths[name]
        opts = CallOptions(rca=0, novel=True)
        host = sorted(call_events(gfa, gtf, opts))
        dev = sorted(call_events_device(gfa, gtf, opts, log=io.StringIO()))
        assert dev == host, name
    assert jax.default_backend() == "gpu"
