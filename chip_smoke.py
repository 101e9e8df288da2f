#!/usr/bin/env python3
"""Smoke test of the device augment and device call paths on one NVIDIA GPU.

    python chip_smoke.py [--mbp 25] [--reads 2000000] [--seed 0]
    python chip_smoke.py --four [--mbp ...]     # the four-card paths, alone

All inputs are made from ``--seed``: a synthetic chromosome at Drosophila
density (100 genes/Mbp with 8 exons and 6 isoforms each, 10k SNPs/Mbp over
20 samples; the default 25 Mbp is one chromosome arm, ~60M count slots),
built with ``python -m pantas_tpu build``, and two replicates of 150 bp
reads sampled along its transcript paths (seeds ``seed`` and ``seed+1``).
Each phase prints one JSON line:

1. ``device``: the card's name and power limit from ``nvidia-smi`` and JAX's
   platform, device kind and count. Exits non-zero unless JAX's platform
   is ``gpu``; nothing falls back to the CPU.
2. ``scatter``: the jitted, donated XLA scatter step on the real slot
   stream of replicate 1 and on 1M-index batches at the 64M- and 268M-slot
   buckets (a padded final batch included), each exact against
   ``np.bincount``; step, host-to-device and per-batch host parse times,
   dense and sparse readback times, ``memory_analysis()`` of the step.
3. ``augment``: ``augment --engine device`` and ``--engine native`` on each
   replicate, byte-identical.
4. ``call``: ``call --engine device -w 3 -n`` and ``--engine host`` on each
   device-augmented GFA under one ``PYTHONHASHSEED``, identical row
   multisets.
5. ``finish``: ``quant`` on the two device-called CSVs, then ``remap``.

then the tests marked ``gpu``, in a child process. The last line is
``{"ok": true, "device": {...}}``; a failed phase exits non-zero without it.
``--four`` runs only the paths that span four cards: ``augment --mesh 4``
and ``--mesh 2x2``, ``call --mesh 4`` and a 4-process ``augment-dist``
with one card each, each compared with the host or native engine.

Only child processes use the card, one at a time: this process never
starts a JAX backend. Every child runs with ``JAX_PLATFORMS=cuda``, so a
child that cannot reach the card fails its phase instead of running on
the CPU.
"""

from __future__ import annotations

import argparse
import collections
import filecmp
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
BATCH = 1 << 20  # slot indices per device batch (the augment stage's own)
BUCKETS = (1 << 26, 1 << 28)
CALL_FLAGS = ["-w", "3", "-n"]
CHILD_TIMEOUT_S = 1800
PLATFORM = "cuda"  # JAX_PLATFORMS of every child process

PROBE = (
    "import json, jax; d = jax.devices(); print(json.dumps({'platform': "
    "d[0].platform, 'kind': d[0].device_kind, 'count': len(d)}))"
)


class PhaseError(RuntimeError):
    """A phase's command failed or its outputs disagree."""


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _env(extra=None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(HERE), env.get("PYTHONPATH")) if p
    )
    env["JAX_PLATFORMS"] = PLATFORM
    env.update(extra or {})
    return env


def run(cmd, env_extra=None, timeout=CHILD_TIMEOUT_S) -> tuple[float, str]:
    """Run ``cmd`` to completion; raise PhaseError on a non-zero exit.
    Returns (wall seconds, captured stdout)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        cmd, cwd=HERE, env=_env(env_extra), capture_output=True, text=True,
        timeout=timeout,
    )
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise PhaseError(
            f"{' '.join(map(str, cmd[:4]))} ... exited {proc.returncode}:\n"
            f"{proc.stderr[-4000:]}"
        )
    return dt, proc.stdout


def cli(*args, env_extra=None) -> float:
    """``python -m pantas_tpu ARGS``; returns its wall seconds."""
    return run([sys.executable, "-m", "pantas_tpu", *map(str, args)], env_extra)[0]


# --- device identity -------------------------------------------------------


def device_identity() -> dict:
    """JAX's view of the devices, from a child process."""
    _, out = run([sys.executable, "-c", PROBE], timeout=600)
    return json.loads(out.strip().splitlines()[-1])


def card_name_and_power() -> list[str]:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except OSError as e:
        raise PhaseError(f"nvidia-smi: {e}") from e
    lines = [ln.strip() for ln in proc.stdout.splitlines() if ln.strip()]
    if proc.returncode != 0 or not lines:
        raise PhaseError(f"nvidia-smi exited {proc.returncode}: {proc.stderr[-500:]}")
    return lines


# --- inputs ------------------------------------------------------------------


def prepare(wd: Path, mbp: float, reads: int, seed: int, replicates: int = 2) -> dict:
    """Generate, build and sample the seeded workload under ``wd``."""
    sys.path.insert(0, str(HERE / "scripts"))
    import stress_build
    from bench_call_scale import synth_gaf

    wd.mkdir(parents=True, exist_ok=True)
    n_chroms = max(1, int(mbp // 25))
    t0 = time.perf_counter()
    stress_build.gen_inputs(
        wd, mbp=mbp, n_var=int(mbp * 10_000), n_genes=max(1, int(mbp * 100)),
        n_samples=20, n_chroms=n_chroms, n_exons=8, n_tx=6, seed=seed,
    )
    gen_s = time.perf_counter() - t0
    build_s = cli("build", wd / "g.fa", wd / "g.gtf", wd / "g.vcf", "-o", wd / "out")
    gfa = wd / "out" / "pantranscriptome-annotated.gfa"
    gafs = []
    t0 = time.perf_counter()
    for r in range(replicates):
        gaf = wd / f"rep{r + 1}.gaf"
        synth_gaf(gfa, reads, gaf, seed=seed + r)
        gafs.append(gaf)
    return {
        "gfa": gfa, "gtf": wd / "g.gtf", "gafs": gafs, "reads": reads,
        "gen_s": gen_s, "build_s": build_s, "sample_s": time.perf_counter() - t0,
        "gfa_bytes": gfa.stat().st_size,
    }


# --- phase 2: the scatter step at real widths ------------------------------


def _stream(width: int, batches) -> dict:
    """Scatter ``batches`` into a zero int32 vector of ``width`` slots with
    the augment stage's jitted step; time each step and its H2D copy."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pantas_tpu.parallel.mesh import scatter_step

    counts = jnp.zeros((width,), jnp.int32)
    first = jax.device_put(batches[0])
    mem = scatter_step.lower(counts, first).compile().memory_analysis()
    t0 = time.perf_counter()
    counts = scatter_step(counts, first)
    counts.block_until_ready()
    first_s = time.perf_counter() - t0
    h2d, steps = [], []
    for b in batches[1:]:
        t0 = time.perf_counter()
        x = jax.device_put(b)
        x.block_until_ready()
        t1 = time.perf_counter()
        counts = scatter_step(counts, x)
        counts.block_until_ready()
        t2 = time.perf_counter()
        h2d.append(t1 - t0)
        steps.append(t2 - t1)
    got = np.asarray(counts)
    valid = np.concatenate([b[b >= 0] for b in batches])
    expect = np.bincount(valid, minlength=width)
    if not np.array_equal(got, expect):
        bad = int(np.count_nonzero(got != expect))
        raise PhaseError(f"scatter at {width} slots differs from bincount in {bad} slots")
    return {
        "width": width,
        "batches": len(batches),
        "indices": int(sum(len(b) for b in batches)),
        "valid": int(len(valid)),
        "nonzero_slots": int(np.count_nonzero(expect)),
        "exact": True,
        "first_call_s": first_s,
        "step_ms_median": 1e3 * statistics.median(steps) if steps else None,
        "h2d_ms_median": 1e3 * statistics.median(h2d) if h2d else None,
        "memory_analysis": {
            k: getattr(mem, k) for k in dir(mem) if k.endswith("_in_bytes")
        } if mem is not None else None,
        "_counts": counts,
    }


def scatter_phase(gfa, gaf, widths=BUCKETS, batch=BATCH, seed=0, synthetic=8) -> dict:
    """The scatter step on replicate 1's real slot stream, then on
    ``synthetic`` uniform batches at each bucket width."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pantas_tpu.coverage.device import read_dense, read_sparse, slot_bucket
    from pantas_tpu.graph.compiler import compile_gfa
    from pantas_tpu.native.gafcov import NativeCoverage

    dev = jax.devices()[0]
    tensors = compile_gfa(str(gfa))
    eng = NativeCoverage(tensors)
    sess = eng.slots_begin(str(gaf), 0, -1, 20)
    batches, parse = [], []
    try:
        while True:
            buf = np.empty(batch, dtype=np.int32)
            t0 = time.perf_counter()
            n = eng.slots_next(sess, buf)
            dt = time.perf_counter() - t0
            if n == 0:
                break
            buf[n:] = -1
            batches.append(buf)
            parse.append(dt)
    finally:
        eng.slots_end(sess)
    if not batches:
        raise PhaseError("replicate 1 produced no slot indices")
    total = tensors.total_slots
    real = _stream(slot_bucket(total), batches)
    counts = real.pop("_counts")
    ref = np.asarray(counts)[:total]
    # dense and sparse readback of the real counts, in turns, each from a
    # fresh device copy (a jax.Array caches its first host copy)
    dense_s, sparse_s = [], []
    for _ in range(3):
        for fn, acc in ((read_dense, dense_s), (read_sparse, sparse_s)):
            fresh = jnp.array(counts, copy=True)
            fresh.block_until_ready()
            t0 = time.perf_counter()
            host = fn(fresh, total)
            acc.append(time.perf_counter() - t0)
            if not np.array_equal(host, ref):
                raise PhaseError(f"{fn.__name__} disagrees with the device counts")
            del fresh, host
    del counts, ref
    real.update(
        graph_slots=int(total),
        parse_ms_per_batch_median=1e3 * statistics.median(parse),
        readback_dense_ms_median=1e3 * statistics.median(dense_s),
        readback_sparse_ms_median=1e3 * statistics.median(sparse_s),
    )
    real["step_over_parse"] = (
        real["step_ms_median"] / real["parse_ms_per_batch_median"]
        if real["step_ms_median"] is not None else None
    )
    rng = np.random.default_rng(seed)
    synth = []
    for w in widths:
        bs = [rng.integers(-1, w, size=batch, dtype=np.int32) for _ in range(synthetic)]
        bs[-1][batch // 2:] = -1  # a padded final partial batch
        res = _stream(w, bs)
        del res["_counts"]
        synth.append(res)
    return {
        "phase": "scatter", "platform": dev.platform, "kind": dev.device_kind,
        "real": real, "synthetic": synth,
    }


# --- phases 3-5 through the CLI --------------------------------------------


def augment_phase(data: dict, wd: Path) -> dict:
    """Device and native augment per replicate; outputs byte-identical."""
    reps = []
    for i, gaf in enumerate(data["gafs"], 1):
        dev_out, nat_out = wd / f"aug{i}.device.gfa", wd / f"aug{i}.native.gfa"
        dev_s = cli("augment", "--engine", "device", gaf, data["gfa"], "-o", dev_out)
        nat_s = cli("augment", "--engine", "native", gaf, data["gfa"], "-o", nat_out)
        if not filecmp.cmp(dev_out, nat_out, shallow=False):
            raise PhaseError(f"replicate {i}: device augment differs from native")
        reps.append({
            "replicate": i, "reads": data["reads"], "identical": True,
            "device_wall_s": dev_s, "native_wall_s": nat_s,
            "bytes": dev_out.stat().st_size,
        })
        nat_out.unlink()
    return {"phase": "augment", "replicates": reps}


def _rows(path: Path) -> collections.Counter:
    with open(path) as fh:
        return collections.Counter(fh.read().splitlines())


def same_rows(a: Path, b: Path) -> bool:
    """Row-multiset equality, the call stage's contract."""
    return _rows(a) == _rows(b)


def call_phase(data: dict, wd: Path, mesh=None) -> dict:
    """Device and host call on each device-augmented GFA; same rows."""
    seed_env = {"PYTHONHASHSEED": "0"}
    reps = []
    mesh_args = ["--mesh", str(mesh)] if mesh else []
    for i in range(1, len(data["gafs"]) + 1):
        aug = wd / f"aug{i}.device.gfa"
        dev_csv, host_csv = wd / f"call{i}.device.csv", wd / f"call{i}.host.csv"
        dev_s = cli("call", "--engine", "device", *mesh_args, *CALL_FLAGS, aug,
                    data["gtf"], "-o", dev_csv, env_extra=seed_env)
        host_s = cli("call", "--engine", "host", *CALL_FLAGS, aug, data["gtf"],
                     "-o", host_csv, env_extra=seed_env)
        if not same_rows(dev_csv, host_csv):
            raise PhaseError(f"replicate {i}: device call rows differ from host")
        reps.append({
            "replicate": i, "rows": sum(_rows(dev_csv).values()) - 1,
            "identical": True, "device_wall_s": dev_s, "host_wall_s": host_s,
        })
    return {"phase": "call", "mesh": mesh, "replicates": reps}


def finish_phase(data: dict, wd: Path) -> dict:
    """quant on the two device-called replicates, then remap."""
    quant, remap = wd / "quant.csv", wd / "quant-remap.csv"
    quant_s = cli("quant", "-o", quant, wd / "call1.device.csv", wd / "call2.device.csv")
    remap_s = cli("remap", quant, data["gtf"], "-o", remap)
    out = {"phase": "finish", "quant_wall_s": quant_s, "remap_wall_s": remap_s}
    for name, path in (("quant", quant), ("remap", remap)):
        rows = sum(_rows(path).values()) - 1
        if rows < 1:
            raise PhaseError(f"{name} wrote no rows")
        out[f"{name}_rows"] = rows
    return out


def gpu_tests() -> dict:
    """The tests marked ``gpu``, on the card, in a child process."""
    dt, out = run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p", "no:cacheprovider",
         str(HERE / "tests")],
    )
    summary = out.strip().splitlines()[-1]
    m = re.search(r"(\d+) passed", summary)
    if not m or re.search(r"skipped|failed|error", summary):
        raise PhaseError(f"gpu tests: {summary}")
    return {"phase": "gpu_tests", "passed": int(m.group(1)), "wall_s": dt}


# --- four cards ----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def augment_dist(gaf: Path, gfa: Path, out: Path, n: int) -> float:
    """``augment-dist`` with ``n`` processes on this host, one card each."""
    port = _free_port()
    flags = " ".join(
        f for f in os.environ.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    procs = []
    t0 = time.perf_counter()
    try:
        for i in range(n):
            env = _env({"JAX_LOCAL_DEVICE_IDS": str(i), "XLA_FLAGS": flags})
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pantas_tpu", "augment-dist", str(gaf),
                 str(gfa), "-o", str(out), "--coordinator", f"127.0.0.1:{port}",
                 "--nprocs", str(n), "--procid", str(i)],
                cwd=HERE, env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True,
            ))
        errs = [p.communicate(timeout=CHILD_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, err) in enumerate(zip(procs, errs)):
        if p.returncode != 0:
            raise PhaseError(f"augment-dist process {i} exited {p.returncode}:\n{err[-3000:]}")
    return time.perf_counter() - t0


def four_phase(data: dict, wd: Path, n: int = 4) -> dict:
    """Mesh augment (1-D and 2-D), mesh call and multi-process augment,
    each against the host or native engine on the same inputs."""
    gaf, gfa = data["gafs"][0], data["gfa"]
    native = wd / "aug1.native.gfa"
    cli("augment", "--engine", "native", gaf, gfa, "-o", native)
    out = {"phase": "four", "augment": {}}
    half = int(n ** 0.5)
    for mesh in (str(n), f"{half}x{n // half}"):
        got = wd / f"aug1.mesh{mesh}.gfa"
        dt = cli("augment", "--engine", "device", "--mesh", mesh, gaf, gfa, "-o", got)
        if not filecmp.cmp(got, native, shallow=False):
            raise PhaseError(f"augment --mesh {mesh} differs from native")
        out["augment"][f"mesh {mesh}"] = {"identical": True, "wall_s": dt}
        if mesh == str(n):
            shutil.copy(got, wd / "aug1.device.gfa")
    dist = wd / "aug1.dist.gfa"
    dt = augment_dist(gaf, gfa, dist, n)
    if not filecmp.cmp(dist, native, shallow=False):
        raise PhaseError(f"{n}-process augment-dist differs from native")
    out["augment"][f"augment-dist x{n}"] = {"identical": True, "wall_s": dt}
    one = dict(data, gafs=data["gafs"][:1])
    out["call"] = call_phase(one, wd, mesh=n)["replicates"][0]
    return out


# --- driver ------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mbp", type=float, default=25.0, help="genome size (default 25)")
    ap.add_argument("--reads", type=int, default=2_000_000, help="reads per replicate")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true", help="only the four-card paths")
    ap.add_argument("--child-scatter", nargs=2, metavar=("GFA", "GAF"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not (HERE / "pantas_tpu" / "__init__.py").is_file():
        print(f"chip_smoke: no pantas_tpu package beside {__file__}", file=sys.stderr)
        return 2
    if args.child_scatter:
        res = scatter_phase(*args.child_scatter, seed=args.seed)
        print(json.dumps(res), flush=True)
        return 0

    t_start = time.perf_counter()
    try:
        device = device_identity()
    except PhaseError as e:
        print(f"chip_smoke: JAX found no CUDA GPU: {e}", file=sys.stderr)
        return 1
    if device["platform"] != "gpu":
        print(
            f"chip_smoke: JAX's platform is {device['platform']!r}, not 'gpu'; "
            "this check runs only on an NVIDIA GPU",
            file=sys.stderr,
        )
        return 1
    need = 4 if args.four else 1
    if device["count"] < need:
        print(f"chip_smoke: needs {need} GPUs, JAX has {device['count']}", file=sys.stderr)
        return 1
    cards = card_name_and_power()
    for line in cards:
        print(line, flush=True)
    card = cards[0]

    from pantas_tpu.native import gafcov, gfaload

    built = {"libgafcov": gafcov.build_library(), "gfaload_ext": gfaload.build_extension()}
    emit({"phase": "device", **device, "nvidia_smi": cards, "native_built": built})

    wd = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        data = prepare(wd, args.mbp, args.reads, args.seed, replicates=1 if args.four else 2)
        emit({
            "phase": "inputs", "mbp": args.mbp, "reads": args.reads, "seed": args.seed,
            "gen_s": data["gen_s"], "build_s": data["build_s"],
            "sample_s": data["sample_s"], "gfa_bytes": data["gfa_bytes"],
        })
        if args.four:
            emit(dict(four_phase(data, wd), card=card))
        else:
            _, out = run([sys.executable, str(HERE / "chip_smoke.py"), "--seed",
                          str(args.seed), "--child-scatter", str(data["gfa"]),
                          str(data["gafs"][0])])
            scatter = json.loads(out.strip().splitlines()[-1])
            if scatter["platform"] != "gpu":
                raise PhaseError(f"scatter ran on {scatter['platform']!r}, not the GPU")
            emit(dict(scatter, card=card))
            emit(dict(augment_phase(data, wd), card=card))
            emit(dict(call_phase(data, wd), card=card))
            emit(dict(finish_phase(data, wd), card=card))
            emit(dict(gpu_tests(), card=card))
    except (PhaseError, subprocess.TimeoutExpired) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f}s",
          file=sys.stderr)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
