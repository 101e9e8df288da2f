"""Device-side coverage accumulation (the device augment engine).

The per-read semantics stay on the host (:mod:`semantics`); what ships to
the device is a flat stream of *count-slot indices* into one counts vector
(layout ``[NC | IL | OL | RC]``, see :mod:`pantas_tpu.graph.compiler`). The
whole augment stage is then a single scatter-add per batch, data-parallel
across the mesh with one psum merge — integer adds are associative, so the
result is bit-exact for any shard count.

Byte-identical GFA emission is preserved by tracking first-seen orders
(IL/OL offsets per node, novel edges) on the host while the counts live on
device.
"""

from __future__ import annotations
from pantas_tpu.io.xopen import xopen

import functools
import os
import sys
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from pantas_tpu.coverage.host import CoverageCounts, emit_augmented_gfa
from pantas_tpu.coverage.semantics import (
    DEFAULT_MAPQ_THR,
    REJECTED,
    SKIPPED,
    ReadEvents,
    read_events,
)
from pantas_tpu.graph.compiler import GraphTensors
from pantas_tpu.io.gaf import parse_gaf_line


class SlotEncoder:
    """Convert ReadEvents into count-slot indices + host-side order tracking."""

    def __init__(self, tensors: GraphTensors):
        self.t = tensors
        self.slots: List[int] = []
        # first-seen orders for byte-identical emission; the dict VALUES are
        # the first-seen stream position (cur_pos) — unused single-process
        # (key order carries the order), but the multi-process merge sorts
        # by them to reconstruct the global file order
        self.il_seen: Dict[int, Dict[int, Optional[int]]] = {}
        self.ol_seen: Dict[int, Dict[int, Optional[int]]] = {}
        self.novel: Dict[Tuple[int, int], int] = {}
        self.novel_order: List[Tuple[int, int]] = []
        self.novel_first: Dict[Tuple[int, int], Optional[int]] = {}
        self.cur_pos: Optional[int] = None  # byte offset of the current record
        self.rejected = 0
        self.skipped = 0
        self.accepted = 0

    def add(self, ev: ReadEvents) -> None:
        t = self.t
        idx = t.node_index
        slots = self.slots
        for name in ev.nodes:
            slots.append(idx[name])
        for name, off in ev.il:
            ni = idx[name]
            slots.append(int(t.il_base[ni]) + off + 1)
            self.il_seen.setdefault(ni, {}).setdefault(off, self.cur_pos)
        for name, off in ev.ol:
            ni = idx[name]
            slots.append(int(t.ol_base[ni]) + off + 1)
            self.ol_seen.setdefault(ni, {}).setdefault(off, self.cur_pos)
        for a, b in ev.edges:
            ai, bi = idx[a], idx[b]
            e = t.edge_lookup(ai, bi)
            if e >= 0:
                slots.append(t.rc_base + e)
            else:
                key = (ai, bi)
                if key not in self.novel:
                    self.novel[key] = 0
                    self.novel_order.append(key)
                    self.novel_first[key] = self.cur_pos
                self.novel[key] += 1

    def take_slots(self) -> np.ndarray:
        arr = np.asarray(self.slots, dtype=np.int32)
        self.slots = []
        return arr


@functools.lru_cache(maxsize=None)
def _sparse_reader(size: int):
    """Jitted (nonzero indices, values) extractor for one size bucket."""
    import jax
    import jax.numpy as jnp

    def _sparse(flat):
        (idx,) = jnp.nonzero(flat, size=size, fill_value=-1)
        return idx, flat[jnp.where(idx >= 0, idx, 0)]

    return jax.jit(_sparse)


def slot_bucket(total: int) -> int:
    """Single-device counts length: the next power of two (at least 4096),
    so one compiled step (and its persistent-cache entry) serves every
    graph in the bucket instead of one compile per graph."""
    return max(1 << 12, 1 << (total - 1).bit_length())


def read_dense(counts, total: int) -> np.ndarray:
    """Copy the first ``total`` slots of a device counts vector to the host."""
    return np.asarray(counts)[:total]


def read_sparse(counts, total: int) -> np.ndarray:
    """The same vector, moved as (nonzero indices, values) plus one scalar.

    Only touched slots are nonzero, so this moves ``8 * nnz`` bytes in
    place of ``4 * total``. Falls back to the dense copy when the vector
    is dense enough that sparse would not help.
    """
    import jax.numpy as jnp

    nnz = int(jnp.sum(counts[:total] != 0))
    if nnz == 0:
        return np.zeros(total, dtype=np.dtype(str(counts.dtype)))
    # power-of-2 size bucket bounds the number of distinct compilations
    size = max(1024, 1 << (nnz - 1).bit_length())
    if 4 * size >= total:
        return read_dense(counts, total)
    idx, vals = _sparse_reader(size)(counts[:total])
    idx_np = np.asarray(idx)
    vals_np = np.asarray(vals)
    out = np.zeros(total, dtype=vals_np.dtype)
    mask = idx_np >= 0
    out[idx_np[mask]] = vals_np[mask]
    return out


class DeviceCoverage:
    """Accumulate a slot stream on device(s).

    ``mesh=None``: single device. 1-D mesh (axis ``data``): data-parallel
    slot shards, one private partial-counts row per device, one reduction
    at stream end. 2-D mesh (``data`` × ``node``): counts additionally
    sharded over the node axis (SURVEY §2.4) — each device owns a
    contiguous slot range and the reduction runs over data only.
    """

    def __init__(self, tensors: GraphTensors, mesh=None):
        import jax.numpy as jnp

        from pantas_tpu.parallel.mesh import (
            NODE_AXIS,
            data_parallel_scatter_add,
            node_sharded_scatter_add,
            scatter_step,
        )

        self.t = tensors
        self.mesh = mesh
        self._jnp = jnp
        self._padded_slots = tensors.total_slots
        if mesh is not None and NODE_AXIS in getattr(mesh, "shape", {}):
            n_node = mesh.shape[NODE_AXIS]
            self._step, shard = node_sharded_scatter_add(mesh, tensors.total_slots)
            self._padded_slots = shard * n_node
            self.n_shards = mesh.shape["data"]
        elif mesh is not None:
            self.n_shards = mesh.devices.size
            self._step = data_parallel_scatter_add(mesh)
        if mesh is not None:
            # per-device PRIVATE partials (data rows); the one reduction
            # the math needs happens once in result()
            self.counts = jnp.zeros(
                (self.n_shards, self._padded_slots), dtype=jnp.int32
            )
        else:
            self.n_shards = 1
            self._step = scatter_step
            self._padded_slots = slot_bucket(tensors.total_slots)
            self.counts = jnp.zeros((self._padded_slots,), dtype=jnp.int32)

    def add_slots(self, slots: np.ndarray, pad_to: Optional[int] = None) -> None:
        """Accumulate a slot batch; pad to a fixed length to avoid retraces.

        Every distinct batch length triggers a fresh jit compile, so callers
        stream fixed-size batches (``pad_to``) with -1 padding.
        """
        if pad_to is not None and len(slots) != pad_to:
            padded = -np.ones(pad_to, dtype=np.int32)
            padded[: len(slots)] = slots
            slots = padded
        if self.mesh is not None and len(slots) % self.n_shards != 0:
            from pantas_tpu.parallel.mesh import pad_to_multiple

            slots = pad_to_multiple(slots, self.n_shards)
        self.counts = self._step(self.counts, self._jnp.asarray(slots))

    def result(self) -> np.ndarray:
        if self.mesh is not None:
            from pantas_tpu.parallel.mesh import reduce_data_parts

            import jax

            merged = jax.jit(reduce_data_parts)(self.counts)
        else:
            merged = self.counts
        # sparse copy: only touched slots are nonzero. On an H100 80GB HBM3
        # at 700 W it read the 236M-slot vector (4.3M nonzero) in 357 ms
        # against 516 ms dense.
        return read_sparse(merged, self.t.total_slots)


def counts_from_device(
    tensors: GraphTensors, enc: SlotEncoder, flat: np.ndarray
) -> CoverageCounts:
    """Assemble host CoverageCounts (for emission) from the device vector."""
    t = tensors
    counts = CoverageCounts()
    counts.rejected = enc.rejected
    counts.skipped = enc.skipped
    counts.accepted = enc.accepted
    counts.node_len = {n: int(l) for n, l in zip(t.node_names, t.node_len)}

    nc = flat[: t.n_nodes]
    for ni in np.nonzero(nc)[0]:
        counts.nc[t.node_names[ni]] = int(nc[ni])

    for ni, seen in enc.il_seen.items():
        base = int(t.il_base[ni])
        counts.il[t.node_names[ni]] = {
            off: int(flat[base + off + 1]) for off in seen
        }
    for ni, seen in enc.ol_seen.items():
        base = int(t.ol_base[ni])
        counts.ol[t.node_names[ni]] = {
            off: int(flat[base + off + 1]) for off in seen
        }

    rc = flat[t.rc_base :]
    for e in np.nonzero(rc)[0]:
        a = t.node_names[int(t.edge_src[e])]
        b = t.node_names[int(t.edge_dst[e])]
        counts.edge[(a, b)] = int(rc[e])
    for ai, bi in enc.novel_order:
        counts.edge[(t.node_names[ai], t.node_names[bi])] = enc.novel[(ai, bi)]
    return counts


def _save_checkpoint(path: str, enc: SlotEncoder, dev: "DeviceCoverage", offset: int):
    """Atomic intra-stream checkpoint: device counts + encoder orders +
    the GAF byte offset of the next unprocessed record.

    Accumulation is pure integer adds, so resuming from the saved offset
    reproduces the one-shot run exactly (deterministic replay — the
    elastic-recovery contract from SURVEY §5)."""
    import pickle

    flat = read_sparse(dev.counts, dev.t.total_slots)
    state = {
        "total_slots": dev.t.total_slots,
        "offset": offset,
        "rejected": enc.rejected,
        "skipped": enc.skipped,
        "accepted": enc.accepted,
        "il_seen": {ni: list(d) for ni, d in enc.il_seen.items()},
        "ol_seen": {ni: list(d) for ni, d in enc.ol_seen.items()},
        "novel": enc.novel,
        "novel_order": enc.novel_order,
    }
    # sparse on disk when it pays (same policy as _save_native_checkpoint):
    # a genome-scale dense counts vector is ~1 GB per save
    nz = np.nonzero(flat)[0]
    if len(nz) * 3 < len(flat):
        state["counts_nz"] = (nz.astype(np.int64), flat[nz])
    else:
        state["counts"] = flat
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(state, fh)
    os.replace(tmp, path)


def _load_checkpoint(path: str, enc: SlotEncoder, dev: "DeviceCoverage") -> int:
    import pickle

    with open(path, "rb") as fh:
        state = pickle.load(fh)
    if state.get("total_slots") != dev.t.total_slots:
        raise ValueError(
            "checkpoint does not match this graph "
            f"(slots {state.get('total_slots')} != {dev.t.total_slots})"
        )
    restored = np.zeros(dev._padded_slots, dtype=np.int32)
    if "counts_nz" in state:
        idx, vals = state["counts_nz"]
        restored[idx] = vals
    else:
        restored[: len(state["counts"])] = state["counts"]
    dev.counts = dev._jnp.asarray(restored)
    enc.rejected = state["rejected"]
    enc.skipped = state["skipped"]
    enc.accepted = state["accepted"]
    enc.il_seen = {ni: dict.fromkeys(offs) for ni, offs in state["il_seen"].items()}
    enc.ol_seen = {ni: dict.fromkeys(offs) for ni, offs in state["ol_seen"].items()}
    enc.novel = state["novel"]
    enc.novel_order = state["novel_order"]
    return int(state["offset"])


def _save_native_checkpoint(path, dev, eng, tensors, offset, base_sidecars,
                            flat=None):
    """Atomic checkpoint of the native-fed device stage: the device counts
    (sparse-read, length ``total_slots``), the GAF byte offset of the next
    unparsed record, and the engine's first-seen sidecar (absolute byte
    positions) chained after any sidecars inherited from prior resumes."""
    import pickle

    from pantas_tpu.parallel.distributed import _native_sidecar

    if flat is None:
        flat = read_sparse(dev.counts, dev.t.total_slots)
    state = {
        "total_slots": tensors.total_slots,
        "offset": int(offset),
        "sidecars": list(base_sidecars) + [_native_sidecar(tensors, eng)],
    }
    nz = np.nonzero(flat)[0]
    if len(nz) * 3 < len(flat):
        # sparse checkpoint: a genome-scale dense counts vector is ~1 GB
        # per save; coverage is sparse, so (indices, values) is ~100x less
        state["counts_nz"] = (nz.astype(np.int64), flat[nz])
    else:
        state["counts"] = flat
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(state, fh)
    os.replace(tmp, path)


def augment_gfa_device_native(
    gaf_path: str,
    gfa_path: str,
    out,
    mapq_thr: int = DEFAULT_MAPQ_THR,
    mesh=None,
    flush_every: int = 1 << 20,
    log=sys.stderr,
    tensors: Optional[GraphTensors] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 8,  # batches between checkpoints
    resume: bool = False,
    _stop_after: Optional[int] = None,  # test hook: simulate interruption
) -> CoverageCounts:
    """Augment with the native parser feeding the device scatter-add.

    The production device path: the C++ GAF tokenizer (native/gafcov.cpp slot
    session) emits fixed-size batches of flat slot indices; the device
    scatter-adds each batch (data-parallel + psum under a mesh) while the
    host parses the next one — the host/device split of the reference
    augmenter (alignments_augmentation_from_gaf.py:134-371: host tokenize,
    device accumulate). First-seen orders stay on the native engine, and the
    device-reduced counts vector is copied back into it for byte-identical
    emission, so the device result is load-bearing for every printed count.

    Elastic recovery (SURVEY §5): with ``checkpoint_path`` the device
    counts + parse offset + first-seen sidecar persist atomically every
    ``checkpoint_every`` batches (the parser's pending residual is drained
    to the device first, so (offset, counts) is consistent); ``resume``
    continues from the saved offset — accumulation is pure integer adds,
    so the result is identical to the uninterrupted run. Resumed runs emit
    through the sidecar-merge path (the same machinery the multi-process
    shards use), non-resumed runs keep the native fast emit.

    Raises :class:`~pantas_tpu.native.gafcov.NativeUnsupported` if the
    native engine cannot take this graph (non-canonical segment ids); the
    CLI then feeds :func:`augment_gfa_device` (pure-Python tokenizer).
    """
    from pantas_tpu.graph.compiler import compile_gfa
    from pantas_tpu.native.gafcov import NativeCoverage

    print("Read GFA (tensorize)", file=log)
    if tensors is None:
        tensors = compile_gfa(gfa_path)
    eng = NativeCoverage(tensors)
    dev = DeviceCoverage(tensors, mesh=mesh)

    if checkpoint_path and mesh is not None:
        raise ValueError("checkpointing supports the single-chip path only")
    start_offset = 0
    base_sidecars: list = []
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        import pickle

        with open(checkpoint_path, "rb") as fh:
            state = pickle.load(fh)
        if state.get("total_slots") != tensors.total_slots:
            raise ValueError(
                "checkpoint does not match this graph "
                f"(slots {state.get('total_slots')} != {tensors.total_slots})"
            )
        restored = np.zeros(dev._padded_slots, dtype=np.int32)
        if "counts_nz" in state:
            idx, vals = state["counts_nz"]
            restored[idx] = vals
        else:
            restored[: tensors.total_slots] = state["counts"]
        dev.counts = dev._jnp.asarray(restored)
        start_offset = state["offset"]
        base_sidecars = state["sidecars"]
        print(f"Resuming from checkpoint at offset {start_offset}", file=log)

    print("Augmentation by GAF alignments (native parse -> device)", file=log)
    sess = eng.slots_begin(gaf_path, start_offset, -1, mapq_thr)
    end_pos = start_offset
    try:
        batches = 0
        while True:
            buf = np.empty(flush_every, dtype=np.int32)
            n = eng.slots_next(sess, buf)
            if n == 0:
                end_pos = eng.slots_pos(sess)
                break
            if n < flush_every:
                buf[n:] = -1  # pad the final partial batch
            dev.add_slots(buf, pad_to=flush_every)
            batches += 1
            if checkpoint_path and batches % max(checkpoint_every, 1) == 0:
                # drain the parser's residual so (offset, counts) agree —
                # a single record can yield more slots than flush_every
                # (very long alignments / tiny batches), so loop to zero
                pend = np.empty(flush_every, dtype=np.int32)
                while (np_ := eng.slots_take_pending(sess, pend)):
                    pend[np_:] = -1
                    dev.add_slots(pend, pad_to=flush_every)
                _save_native_checkpoint(
                    checkpoint_path, dev, eng, tensors,
                    eng.slots_pos(sess), base_sidecars,
                )
                if _stop_after is not None and batches >= _stop_after:
                    return None  # test hook: simulate a crash after a save
        flat = dev.result()
    finally:
        eng.slots_end(sess)
    if checkpoint_path:
        # EOF marker offset must be the parser's own end position —
        # os.path.getsize is the COMPRESSED size for a .gz input, which
        # as a decompressed-stream offset would make a resume-after-
        # completion re-parse (and double-count) the tail. The counts
        # result() just read back are reused: no second device readback.
        _save_native_checkpoint(
            checkpoint_path, dev, eng, tensors, end_pos, base_sidecars,
            flat=flat[: tensors.total_slots]
            if len(flat) >= tensors.total_slots else flat,
        )

    if base_sidecars:
        # resumed run: rebuild the GLOBAL first-seen orders by merging the
        # pre-interruption sidecar with this run's (same machinery as the
        # multi-process shard merge), then emit via the encoder path
        from pantas_tpu.parallel.distributed import (
            _merge_sidecars,
            _native_sidecar,
        )

        enc = _merge_sidecars(
            tensors, base_sidecars + [_native_sidecar(tensors, eng)]
        )
        counts = counts_from_device(tensors, enc, flat)
        print(f"Rejected alignments: {counts.rejected}", file=log)
        print("Annotating GFA", file=log)
        emit_augmented_gfa(gfa_path, counts, out)
        return counts

    eng.set_counts(flat)  # device-reduced values back the emission
    print(f"Rejected alignments: {int(eng.lib.gafcov_rejected(eng.handle))}", file=log)
    print("Annotating GFA", file=log)
    import io as _io

    try:
        out.flush()
        fd = out.fileno()
    except (AttributeError, OSError, _io.UnsupportedOperation):
        fd = None
    if fd is not None:
        eng.emit(gfa_path, fd)
        counts = CoverageCounts()
        counts.rejected = int(eng.lib.gafcov_rejected(eng.handle))
        counts.skipped = int(eng.lib.gafcov_skipped(eng.handle))
        counts.accepted = int(eng.lib.gafcov_accepted(eng.handle))
        return counts
    counts = eng.to_counts()
    emit_augmented_gfa(gfa_path, counts, out)
    return counts


def augment_gfa_device(
    gaf_path: str,
    gfa_path: str,
    out,
    mapq_thr: int = DEFAULT_MAPQ_THR,
    mesh=None,
    flush_every: int = 1 << 20,
    log=sys.stderr,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,  # flushes between checkpoints
    resume: bool = False,
) -> CoverageCounts:
    """Full augment stage with device-side accumulation.

    Pure-Python tokenizer feed — the portable/checkpointable variant;
    production runs use :func:`augment_gfa_device_native` (same device
    compute, ~100x faster host feed). With ``checkpoint_path``, the device
    counts and encoder state persist atomically every ``checkpoint_every``
    flushes; ``resume=True`` continues a previous run from its saved GAF
    offset.
    """
    from pantas_tpu.graph.compiler import compile_gfa

    if checkpoint_path and mesh is not None:
        # same guard as the native path: a checkpoint stores mesh-shaped
        # partials, and a resume under a different mesh would fail with
        # an opaque shape error deep in jax
        raise ValueError("checkpointing supports the single-chip path only")
    print("Read GFA (tensorize)", file=log)
    tensors = compile_gfa(gfa_path)
    node_len = {n: int(l) for n, l in zip(tensors.node_names, tensors.node_len)}

    enc = SlotEncoder(tensors)
    dev = DeviceCoverage(tensors, mesh=mesh)

    start_offset = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        start_offset = _load_checkpoint(checkpoint_path, enc, dev)
        print(f"Resuming from checkpoint at offset {start_offset}", file=log)

    def flush():
        batch = enc.take_slots()
        for i in range(0, len(batch), flush_every):
            dev.add_slots(batch[i : i + flush_every], pad_to=flush_every)

    print("Augmentation by GAF alignments (device scatter-add)", file=log)
    flushes = 0
    with xopen(gaf_path, "rb") as fh:
        fh.seek(start_offset)
        pos = start_offset
        while True:
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
                flush()
                flushes += 1
                if checkpoint_path and flushes % max(checkpoint_every, 1) == 0:
                    _save_checkpoint(checkpoint_path, enc, dev, fh.tell())
    if enc.slots:
        flush()
    if checkpoint_path:
        # EOF marker = the reader's decompressed end offset (getsize is
        # the COMPRESSED size for a .gz input — a resume from it would
        # re-parse and double-count the tail)
        _save_checkpoint(checkpoint_path, enc, dev, pos)

    counts = counts_from_device(tensors, enc, dev.result())
    print(f"Rejected alignments: {counts.rejected}", file=log)
    print("Annotating GFA", file=log)
    emit_augmented_gfa(gfa_path, counts, out)
    return counts
