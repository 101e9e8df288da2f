"""Mesh construction and the data-parallel coverage collective.

The only cross-device reduction the pipeline's math needs is an integer sum
of coverage partial counts (reads are i.i.d. work items whose contributions
are commutative scatter-adds), so the communication layer is exactly one
``psum`` over the data axis — associative integer adds make the result
bit-exact regardless of topology or shard count.

The reference has no distributed runtime at all (its parallelism is one OS
process per chromosome/replicate, ``build/build.smk`` + Snakemake); this
module replaces it with N devices per replicate instead of one process per
replicate.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

DATA_AXIS = "data"


def coverage_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    import numpy as np

    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs, (DATA_AXIS,))


def scatter_add_counts(counts: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """counts[idx] += 1 for every valid (>= 0) index; -1 entries are padding."""
    safe = jnp.where(idx >= 0, idx, 0)
    val = (idx >= 0).astype(counts.dtype)
    return counts.at[safe].add(val)


# The single-device augment step. XLA lowers the scatter-add to native
# atomic adds on a GPU. The counts buffer is donated: at genome scale it is
# ~1 GB, and an undonated step would copy it every batch.
scatter_step = jax.jit(scatter_add_counts, donate_argnums=(0,))


def data_parallel_scatter_add(mesh: Mesh):
    """Build the sharded coverage accumulator for a mesh.

    Returns a jitted fn ``(parts, idx) -> parts`` where ``idx`` is sharded
    over the data axis and ``parts`` is a per-device PRIVATE partial-counts
    matrix ``(n_data, slots)`` sharded over its leading axis: each device
    scatter-adds its stream shard into its own row with ZERO per-batch
    communication. The single reduction the math needs (integer adds are
    associative) happens once at stream end in :func:`reduce_data_parts` —
    the collective equivalent of the reference's per-replicate process
    merge, paid once instead of per batch.
    """

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS),
    )
    def _dp(parts, idx_shard):
        return scatter_add_counts(parts.reshape(-1), idx_shard).reshape(
            parts.shape
        )

    return jax.jit(_dp)


def reduce_data_parts(parts):
    """The one end-of-stream reduction: sum partials over the data axis."""
    return jnp.sum(parts, axis=0)


NODE_AXIS = "node"


def coverage_mesh_2d(devices, data: int, node: int) -> Mesh:
    """2-D mesh: data-parallel GAF shards × node-axis-sharded counts.

    The node axis is the framework's model/graph-parallel analogue (SURVEY
    §2.4): node ids are topologically sorted and chromosome-contiguous
    (combine's id-shift invariant), so contiguous count shards keep each
    chromosome's traffic on one shard group.
    """
    import numpy as np

    devs = np.asarray(devices).reshape(data, node)
    return Mesh(devs, (DATA_AXIS, NODE_AXIS))


def node_sharded_scatter_add(mesh: Mesh, total_slots: int):
    """Coverage step over a 2-D (data × node) mesh.

    Partial counts are sharded over BOTH axes: shape ``(n_data, padded)``
    with rows on the data axis and each row's slot range on the node axis.
    Every device owns the ``(data row, node range)`` tile it accumulates
    into: it scatter-adds only the stream indices that fall inside its
    node-shard range (others mask to zero) with ZERO per-batch
    communication — ownership is by slot range, and the one data-axis
    reduction happens at stream end (:func:`reduce_data_parts`).
    """
    n_node = mesh.shape[NODE_AXIS]
    shard = -(-total_slots // n_node)  # ceil; counts padded to shard * n_node

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, NODE_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS, NODE_AXIS),
    )
    def _step(counts_tile, idx_shard):
        my_node = jax.lax.axis_index(NODE_AXIS)
        base = my_node * shard
        local = idx_shard - base
        ok = (idx_shard >= 0) & (local >= 0) & (local < shard)
        safe = jnp.where(ok, local, 0)
        flat = counts_tile.reshape(-1)
        return flat.at[safe].add(ok.astype(flat.dtype)).reshape(
            counts_tile.shape
        )

    return jax.jit(_step), shard


def pad_to_multiple(idx, multiple: int):
    """Pad an int32 index array with -1 so it splits evenly over devices."""
    import numpy as np

    n = len(idx)
    padded = -np.ones((-(-n // multiple)) * multiple or multiple, dtype=np.int32)
    padded[:n] = idx
    return padded
