"""Device mesh construction and sharding specs for the model state.

The replacement for the reference's block decomposition + MPI rank
layout (``ice_blocks.F90`` / ``ice_distribution.F90``): one 2D
`jax.sharding.Mesh` over ('y', 'x'); every field is sharded over its
trailing two (spatial) axes with category/layer axes replicated.  XLA's
SPMD partitioner inserts all halo communication (NCCL
collective-permutes for the `jnp.roll` stencils on GPUs) and
reductions — there is no hand-written message schedule
(`ice_HaloCreate`) to maintain.  The k-halo fast paths
(`ops/evp_sharded.py`, `remap.transport_remap_sharded`) replace the
per-roll permutes with one batched exchange.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed():
    """Multi-host initialization behind a flag
    (``jax.distributed.initialize``; the analogue of
    `init_communicate`, ``mpi/ice_communicate.F90:74-141``).

    Set CICE4_DISTRIBUTED=1 together with CICE4_COORDINATOR
    (``host:port``), CICE4_NUM_PROCESSES and CICE4_PROCESS_ID to join
    a multi-process mesh (one process per GPU or per host); without
    CICE4_COORDINATOR JAX's own cluster auto-detection is tried.
    No-op otherwise and safe to call twice.
    """
    import os
    if not os.environ.get("CICE4_DISTRIBUTED"):
        return False
    kw = {}
    # explicit rendezvous (localhost multi-process testing and
    # clusters without an auto-detected environment)
    if os.environ.get("CICE4_COORDINATOR"):
        kw = dict(
            coordinator_address=os.environ["CICE4_COORDINATOR"],
            num_processes=int(os.environ["CICE4_NUM_PROCESSES"]),
            process_id=int(os.environ["CICE4_PROCESS_ID"]),
        )
    try:
        jax.distributed.initialize(**kw)
        return True
    except RuntimeError:
        return True  # already initialized


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Build a near-square (py, px) mesh from the available devices
    (the analogue of `proc_decomposition`, ``ice_distribution.F90:
    228-377``, with `processor_shape = 'square-ice'`).  GPUs joined
    all to all by NVLink have no torus to follow, so the shape follows
    the halo perimeter alone (2x2 for four cards)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    py = int(math.sqrt(n))
    while n % py != 0:
        py -= 1
    px = n // py
    dev_array = np.asarray(devices).reshape(py, px)
    return Mesh(dev_array, ("y", "x"))


def spatial_spec(ndim: int) -> P:
    """PartitionSpec sharding the trailing (y, x) axes of an
    `ndim`-rank array; leading category/layer axes replicated."""
    if ndim < 2:
        return P()
    return P(*([None] * (ndim - 2) + ["y", "x"]))


def shard_pytree(tree, mesh: Mesh):
    """Place every array leaf of a pytree with its spatial sharding."""
    def place(leaf):
        if hasattr(leaf, "ndim") and leaf.ndim >= 2:
            return jax.device_put(
                leaf, NamedSharding(mesh, spatial_spec(leaf.ndim)))
        return leaf

    return jax.tree_util.tree_map(place, tree)


def pytree_shardings(tree, mesh: Mesh):
    """Matching NamedSharding pytree (for jit in_shardings)."""
    def spec(leaf):
        if hasattr(leaf, "ndim"):
            return NamedSharding(mesh, spatial_spec(leaf.ndim))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map(spec, tree)


# ---------------------------------------------------------------------------
# active-mesh context: lets ops opt into explicit shard_map fast paths
# ---------------------------------------------------------------------------

_ACTIVE_MESH = None


def set_active_mesh(mesh):
    """Register the mesh the model is being sharded over (or None).

    GSPMD needs no registration — sharding propagates from the inputs —
    but the hand-scheduled fast paths (k-halo EVP subcycling,
    `ops/evp_sharded.py`) need the concrete mesh + axis names to issue
    `shard_map`/`ppermute`.  The driver / dryrun sets this when it
    shards the state; `None` restores pure-GSPMD behavior."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_active_mesh():
    return _ACTIVE_MESH
