#!/usr/bin/env python3
"""END-TO-END multi-process sharded augment scaling (real GAF, real graph).

Unlike bench_scaling.py (which times only the device scatter-add step),
this drives the full multi-host contract: N OS processes coordinate via
jax.distributed (Gloo on CPU, NCCL on GPUs), each streams its contiguous
byte range of the GAF through the host tokenizer + device scatter-add,
partial counts merge with one cross-process all-reduce, first-seen orders
merge via sidecars, and process 0 emits the augmented GFA — which is
byte-compared against the single-process host engine.

Usage: python scripts/bench_scaling_e2e.py [n_records] [proc_counts...]
Defaults: 100000 records from the bench workload, proc counts 1 2.

Writes one JSON line per configuration. Note the honest caveat: this host
has few physical cores, so CPU efficiency saturates at the core count; on
several hosts the same code path shards across real machines.
"""

import io
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

N_RECORDS = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
PROCS = [int(x) for x in sys.argv[2:]] or [1, 2]

CACHE = REPO / ".bench"


def ensure_inputs():
    gfa = CACHE / "pantranscriptome-annotated.gfa"
    big = CACHE / "big.gaf"
    if not (gfa.exists() and big.exists()):
        print("run `python bench.py` once to materialize the workload", file=sys.stderr)
        sys.exit(1)
    sub = CACHE / f"scal_{N_RECORDS}.gaf"
    if not sub.exists():
        with open(big) as src, open(sub, "w") as dst:
            for i, line in enumerate(src):
                if i >= N_RECORDS:
                    break
                dst.write(line)
    return gfa, sub


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_n(gfa, gaf, n, out):
    """Returns (wall_s, max_accum_s): wall includes fixed jax/Gloo startup;
    accum is the per-process accumulate phase (the part that scales)."""
    import re

    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env.pop("XLA_FLAGS", None)  # one device per CPU process
    t0 = time.time()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "pantas_tpu", "augment-dist",
             str(gaf), str(gfa), "-o", str(out),
             "--coordinator", f"127.0.0.1:{port}",
             "--nprocs", str(n), "--procid", str(i)],
            # one card per process on a GPU host; JAX_PLATFORMS=cpu for Gloo
            env=dict(env, JAX_LOCAL_DEVICE_IDS=str(i)),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        )
        for i in range(n)
    ]
    accums = []
    for p in procs:
        _, err = p.communicate(timeout=1800)
        assert p.returncode == 0, err[-3000:]
        m = re.search(r"accumulate ([0-9.]+)s", err)
        if m:
            accums.append(float(m.group(1)))
    return time.time() - t0, max(accums) if accums else None


def main():
    gfa, gaf = ensure_inputs()
    n_reads = sum(1 for _ in open(gaf))

    print(f"[e2e-scaling] single-process host engine (expected output)..", file=sys.stderr)
    from pantas_tpu.coverage import augment_gfa

    expected = io.StringIO()
    t0 = time.time()
    augment_gfa(str(gaf), str(gfa), out=expected, log=io.StringIO())
    host_s = time.time() - t0
    print(f"[e2e-scaling] host engine: {host_s:.1f}s", file=sys.stderr)

    base = None
    for n in PROCS:
        out = CACHE / f"scal_out_{n}.gfa"
        dt, accum = run_n(gfa, gaf, n, out)
        identical = out.read_text() == expected.getvalue()
        rate = n_reads / accum if accum else n_reads / dt
        if base is None:
            base = rate
        eff = rate / (base * n / PROCS[0])
        print(json.dumps({
            "metric": "augment_e2e_sharded",
            "procs": n,
            "reads": n_reads,
            "wall_s": round(dt, 2),
            "accum_s": round(accum, 3) if accum else None,
            "reads_per_s": round(rate),
            "efficiency_vs_linear": round(eff, 3),
            "byte_identical": identical,
        }))
        assert identical, f"{n}-process emission differs from host engine"
        out.unlink()


if __name__ == "__main__":
    main()
