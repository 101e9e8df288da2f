"""The coverage scatter-add step: exact against ``np.bincount``.

All device math on this path is int32, so every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pantas_tpu.coverage.device import read_dense, read_sparse
from pantas_tpu.parallel.mesh import scatter_add_counts, scatter_step


def test_xla_scatter_ignores_padding():
    counts = jnp.zeros(16, dtype=jnp.int32)
    idx = jnp.asarray(np.array([3, -1, 3, 0, -1], dtype=np.int32))
    out = np.asarray(jax.jit(scatter_add_counts)(counts, idx))
    assert out[3] == 2 and out[0] == 1 and out.sum() == 3


@pytest.mark.parametrize(
    "width,batch,n_batches,pad_tail,preload",
    [
        (1 << 12, 1 << 10, 1, False, False),
        (1 << 12, 1 << 10, 3, True, False),
        (1 << 16, 1 << 12, 4, True, True),
        (1 << 16, 1 << 14, 2, False, True),
        (1 << 20, 1 << 16, 3, True, False),
        (5000, 1 << 11, 2, True, True),
    ],
)
def test_scatter_step_matches_bincount(width, batch, n_batches, pad_tail, preload):
    """Streamed, donated, fixed-size batches: -1 padding mixed in and a
    padded final partial batch, onto zero or preloaded counts."""
    rng = np.random.default_rng(width ^ batch)
    base = (
        rng.integers(0, 7, size=width, dtype=np.int32)
        if preload else np.zeros(width, dtype=np.int32)
    )
    counts = jnp.asarray(base)
    expect = base.astype(np.int64)
    for b in range(n_batches):
        idx = rng.integers(-1, width, size=batch, dtype=np.int32)
        if pad_tail and b == n_batches - 1:
            idx[batch // 3:] = -1
        expect += np.bincount(idx[idx >= 0], minlength=width)
        counts = scatter_step(counts, jnp.asarray(idx))
    got = np.asarray(counts)
    assert got.dtype == np.int32
    assert np.array_equal(got, expect.astype(np.int32))


@pytest.mark.parametrize("fill", [0.0, 0.001, 0.3])
def test_readbacks_agree(fill):
    """Dense and sparse device->host readbacks return the same vector,
    including the empty and the dense-enough-to-fall-back cases."""
    rng = np.random.default_rng(5)
    total = 50_000
    vec = np.zeros(1 << 16, dtype=np.int32)
    nz = rng.choice(total, size=int(fill * total), replace=False)
    vec[nz] = rng.integers(1, 100, size=len(nz), dtype=np.int32)
    dev = jnp.asarray(vec)
    dense = read_dense(dev, total)
    assert np.array_equal(dense, vec[:total])
    assert np.array_equal(read_sparse(dev, total), dense)
