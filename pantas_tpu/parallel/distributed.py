"""Multi-process (multi-host) sharded augment with byte-identical emission.

The multi-host contract (SURVEY §2.4 / §5 "communication backend"): GAF
records are i.i.d. scatter-add work items, so each process streams a
contiguous byte range of the GAF, accumulates a private partial-counts
vector on its local device(s), and the partials merge with ONE cross-process
integer all-gather (Gloo on CPU, NCCL on GPUs) — bit-exact for any process
count because integer adds are associative.

Byte-identical GFA emission additionally needs the GLOBAL first-seen orders
(IL/OL offsets per node, novel edges) that the reference's single-stream
augmenter produces implicitly. Each process records the byte offset at
which it first saw each order-bearing item; process 0 merges the per-process
sidecars by minimum offset — contiguous ranges make that the exact global
file order — and emits.

Run one process per host:

    python -m pantas_tpu augment-dist GAF GFA -o OUT \
        --coordinator HOST:PORT --nprocs N --procid I

or one per card of a shared host, giving process I its card with
``JAX_LOCAL_DEVICE_IDS=I`` (read by ``jax.distributed.initialize``).

(`tests/test_distributed.py` drives a local 2-process run and byte-compares
against the single-process engine.)
"""

from __future__ import annotations

import os
import pickle
import sys
import time
from typing import Optional

import numpy as np

DEFAULT_MAPQ_THR = 20


def shard_byte_ranges(path: str, n: int):
    """Split a file into n contiguous byte ranges at line boundaries."""
    size = os.path.getsize(path)
    bounds = [0]
    with open(path, "rb") as fh:
        for i in range(1, n):
            guess = size * i // n
            fh.seek(guess)
            fh.readline()  # advance to the next line start
            bounds.append(min(fh.tell(), size))
    bounds.append(size)
    return [(bounds[i], bounds[i + 1]) for i in range(n)]


def _native_sidecar(tensors, eng) -> dict:
    """Convert the native engine's first-seen sidecars (slot order + byte
    positions) into the per-process dict format ``_merge_sidecars`` expects
    (the same structure the Python SlotEncoder records)."""
    il_seen: dict = {}
    ol_seen: dict = {}
    order, pos = eng.seen_sidecar()
    if len(order):
        t = tensors
        hist_total = int(t.ol_base[0] - t.il_base[0]) if t.n_nodes else 0
        il_end = int(t.il_base[0]) + hist_total
        for slot, p in zip(order, pos):
            slot = int(slot)
            if slot < il_end:
                ni = int(np.searchsorted(t.il_base, slot, side="right")) - 1
                il_seen.setdefault(ni, {})[slot - int(t.il_base[ni]) - 1] = int(p)
            else:
                ni = int(np.searchsorted(t.ol_base, slot, side="right")) - 1
                ol_seen.setdefault(ni, {})[slot - int(t.ol_base[ni]) - 1] = int(p)
    novel: dict = {}
    novel_first: dict = {}
    keys, vals, poss = eng.novel_sidecar()
    for k, v, p in zip(keys, vals, poss):
        key = (int(k >> np.uint64(32)), int(k & np.uint64(0xFFFFFFFF)))
        novel[key] = int(v)
        novel_first[key] = int(p)
    lib, h = eng.lib, eng.handle
    return {
        "rejected": int(lib.gafcov_rejected(h)),
        "skipped": int(lib.gafcov_skipped(h)),
        "accepted": int(lib.gafcov_accepted(h)),
        "il_seen": il_seen,
        "ol_seen": ol_seen,
        "novel": novel,
        "novel_first": novel_first,
    }


def _merge_sidecars(tensors, sidecars):
    """Rebuild the single-stream encoder state from per-process sidecars."""
    from pantas_tpu.coverage.device import SlotEncoder

    enc = SlotEncoder(tensors)
    il: dict = {}
    ol: dict = {}
    for sc in sidecars:
        enc.rejected += sc["rejected"]
        enc.skipped += sc["skipped"]
        enc.accepted += sc["accepted"]
        for ni, d in sc["il_seen"].items():
            mine = il.setdefault(ni, {})
            for off, pos in d.items():
                if off not in mine or pos < mine[off]:
                    mine[off] = pos
        for ni, d in sc["ol_seen"].items():
            mine = ol.setdefault(ni, {})
            for off, pos in d.items():
                if off not in mine or pos < mine[off]:
                    mine[off] = pos
        for key, cnt in sc["novel"].items():
            if key not in enc.novel:
                enc.novel[key] = 0
                enc.novel_first[key] = sc["novel_first"][key]
            enc.novel[key] += cnt
            enc.novel_first[key] = min(enc.novel_first[key], sc["novel_first"][key])
    # global first-seen order = ascending first byte offset
    enc.il_seen = {
        ni: dict.fromkeys(sorted(d, key=d.__getitem__)) for ni, d in il.items()
    }
    enc.ol_seen = {
        ni: dict.fromkeys(sorted(d, key=d.__getitem__)) for ni, d in ol.items()
    }
    enc.novel_order = sorted(enc.novel, key=enc.novel_first.__getitem__)
    return enc


def augment_gfa_distributed(
    gaf_path: str,
    gfa_path: str,
    out_path: str,
    coordinator: str,
    n_procs: int,
    proc_id: int,
    mapq_thr: int = DEFAULT_MAPQ_THR,
    workdir: Optional[str] = None,
    log=sys.stderr,
):
    """One process of the sharded augment; process 0 writes ``out_path``.

    Runs on JAX's default platform, on the local devices that
    ``JAX_LOCAL_DEVICE_IDS`` names (all of them when it is unset).

    Returns the per-process wall time of the accumulate phase (for the
    scaling-efficiency report).
    """
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=n_procs, process_id=proc_id
    )
    from jax.experimental import multihost_utils

    from pantas_tpu.coverage.device import (
        DeviceCoverage,
        SlotEncoder,
        counts_from_device,
    )
    from pantas_tpu.coverage.host import emit_augmented_gfa
    from pantas_tpu.coverage.semantics import REJECTED, SKIPPED, read_events
    from pantas_tpu.graph.compiler import compile_gfa
    from pantas_tpu.io.gaf import parse_gaf_line

    from pantas_tpu.io.xopen import is_compressed

    if is_compressed(gaf_path):
        # shard_byte_ranges splits COMPRESSED bytes while the slot
        # sessions interpret lo/hi as DECOMPRESSED-stream offsets — the
        # shards would silently cover only a prefix of the stream.
        # (Single-process engines accept compressed input; decompress
        # first for the distributed path.)
        raise ValueError(
            "augment-dist does not support compressed GAF input; "
            "decompress first"
        )
    workdir = workdir or os.path.dirname(os.path.abspath(out_path))
    tensors = compile_gfa(gfa_path)
    node_len = {n: int(l) for n, l in zip(tensors.node_names, tensors.node_len)}
    enc = SlotEncoder(tensors)
    dev = DeviceCoverage(tensors)  # local accumulation; merge is global

    ranges = shard_byte_ranges(gaf_path, n_procs)
    lo, hi = ranges[proc_id]
    flush_every = 1 << 20
    # compile the scatter step before the timed accumulate phase (an all-
    # padding batch adds nothing; jit compile is per-process fixed overhead,
    # not scaling work)
    dev.add_slots(np.full(flush_every, -1, dtype=np.int32), pad_to=flush_every)
    t0 = time.time()
    native_eng = None
    try:
        from pantas_tpu.native.gafcov import NativeCoverage

        native_eng = NativeCoverage(tensors)
    except Exception as e:  # non-canonical ids / no toolchain
        print(f"[augment-dist] python feed ({e})", file=log)
    if native_eng is not None:
        # fast path: native parse of this process's byte range feeding the
        # local device(s); sidecars carry absolute byte offsets for the
        # global first-seen order merge
        sess = native_eng.slots_begin(gaf_path, lo, hi, mapq_thr)
        try:
            while True:
                buf = np.empty(flush_every, dtype=np.int32)
                n = native_eng.slots_next(sess, buf)
                if n == 0:
                    break
                if n < flush_every:
                    buf[n:] = -1
                dev.add_slots(buf, pad_to=flush_every)
            local = dev.result()
        finally:
            native_eng.slots_end(sess)
    else:
        with open(gaf_path, "rb") as fh:
            fh.seek(lo)
            pos = lo
            while pos < hi:
                raw = fh.readline()
                if not raw:
                    break
                enc.cur_pos = pos
                pos += len(raw)
                line = raw.decode()
                if line.strip():
                    ev = read_events(parse_gaf_line(line), node_len, mapq_thr)
                    if ev is REJECTED:
                        enc.rejected += 1
                    elif ev is SKIPPED:
                        enc.skipped += 1
                    else:
                        enc.accepted += 1
                        enc.add(ev)
                if len(enc.slots) >= flush_every:
                    batch = enc.take_slots()
                    for i in range(0, len(batch), flush_every):
                        dev.add_slots(batch[i : i + flush_every], pad_to=flush_every)
        if enc.slots:
            batch = enc.take_slots()
            for i in range(0, len(batch), flush_every):
                dev.add_slots(batch[i : i + flush_every], pad_to=flush_every)
        local = dev.result()
    accum_s = time.time() - t0

    # ONE cross-process integer reduction (the framework's entire
    # multi-host communication for this stage)
    gathered = multihost_utils.process_allgather(local)
    global_counts = np.asarray(gathered).sum(axis=0).astype(np.int32)

    sidecar = os.path.join(workdir, f".augshard.{proc_id}.pkl")
    if native_eng is not None:
        sc = _native_sidecar(tensors, native_eng)
    else:
        sc = {
            "rejected": enc.rejected,
            "skipped": enc.skipped,
            "accepted": enc.accepted,
            "il_seen": enc.il_seen,
            "ol_seen": enc.ol_seen,
            "novel": enc.novel,
            "novel_first": enc.novel_first,
        }
    sc["accum_s"] = accum_s
    with open(sidecar + ".tmp", "wb") as fh:
        pickle.dump(sc, fh)
    os.replace(sidecar + ".tmp", sidecar)
    multihost_utils.sync_global_devices("pantas-augment-sidecars")

    if proc_id == 0:
        sidecars = []
        for i in range(n_procs):
            with open(os.path.join(workdir, f".augshard.{i}.pkl"), "rb") as fh:
                sidecars.append(pickle.load(fh))
        merged = _merge_sidecars(tensors, sidecars)
        counts = counts_from_device(tensors, merged, global_counts)
        print(f"Rejected alignments: {counts.rejected}", file=log)
        with open(out_path, "w") as out:
            emit_augmented_gfa(gfa_path, counts, out)
        for i in range(n_procs):
            os.remove(os.path.join(workdir, f".augshard.{i}.pkl"))
    multihost_utils.sync_global_devices("pantas-augment-emitted")
    return accum_s
