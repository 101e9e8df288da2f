#!/usr/bin/env python3
"""Data-parallel coverage scaling harness.

Measures the sharded scatter-add + psum step over an N-device mesh at fixed
TOTAL work, reporting throughput and scaling efficiency vs 1 device. On
several accelerators this is the ≥80%-efficiency check from BASELINE.md.
It runs on JAX's default platform; ``JAX_PLATFORMS=cpu`` gives up to
``max_devices`` virtual CPU devices (methodology + correctness, not
device rates: virtual-device scaling saturates at the host's core count).

Usage: python scripts/bench_scaling.py [max_devices] [stream_size]
"""

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

MAX_DEV = int(sys.argv[1]) if len(sys.argv) > 1 else 8
STREAM = int(sys.argv[2]) if len(sys.argv) > 2 else 1 << 23

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={MAX_DEV}"
    ).strip()

import jax  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pantas_tpu.parallel.mesh import (  # noqa: E402
    coverage_mesh,
    data_parallel_scatter_add,
)


def main():
    devices = jax.devices()
    n_slots = 1 << 20
    rng = np.random.default_rng(0)
    idx_np = rng.integers(0, n_slots, size=STREAM, dtype=np.int32)
    expect = np.bincount(idx_np, minlength=n_slots).astype(np.int32)

    base_rate = None
    results = []
    d = 1
    while d <= len(devices):
        mesh = coverage_mesh(devices[:d])
        step = data_parallel_scatter_add(mesh)
        counts = jnp.zeros((d, n_slots), dtype=jnp.int32)  # private partials
        idx = jnp.asarray(idx_np)  # STREAM % d == 0 for powers of two
        from pantas_tpu.parallel.mesh import reduce_data_parts

        reduce = jax.jit(reduce_data_parts)
        out = reduce(step(counts, idx))
        out.block_until_ready()
        assert np.array_equal(np.asarray(out), expect), f"mismatch at d={d}"
        ts = []
        for _ in range(3):
            t0 = time.time()
            step(counts, idx).block_until_ready()
            ts.append(time.time() - t0)
        rate = STREAM / min(ts)
        if base_rate is None:
            base_rate = rate
        results.append(
            {
                "devices": d,
                "m_idx_per_s": round(rate / 1e6, 2),
                "efficiency": round(rate / (base_rate * d), 3),
                "bit_exact": True,
            }
        )
        d *= 2

    print(json.dumps({"scaling": results, "platform": str(devices[0].platform)}))


if __name__ == "__main__":
    main()
