"""Decomposition twin check: one step sharded over a mesh vs one device.

The analogue of the reference's serial/mpi twin diff (SURVEY §4.5,
-DREPRODUCIBLE + DITTO): the physics is decomposition-invariant, so a
step sharded over a (y, x) device mesh must reproduce the step on one
device to roundoff.  Used by ``chip_smoke.py --multi`` on GPUs and by
``__graft_entry__.dryrun_multichip`` on virtual CPU devices.

`twin_lower` traces both programs and `twin_compare` runs compiled
ones, so a caller can compile several twins concurrently.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

TWIN_FIELDS = ("aicen", "vicen", "vsnon", "eicen", "uvel", "vvel",
               "tsfcn", "sst")
# Pointwise bound, 2e-5 of max(|x|, 1).  The sharded step has to round
# exactly as the unsharded one does: one step's EVP amplifies any
# roundoff difference to O(1e-2) of the ice speed (PERF.md).  Measured:
# 0 on virtual CPU devices and on four H100s (1440x1080 tripole and
# 320x384 closed, ndte=120).
TWIN_RTOL = 2e-5


def twin_lower(cfg, mesh, dtype=jnp.float32, yday=80.0, sec=0.0):
    """Build one initial state and trace the step twice: unsharded on
    the mesh's first device (``ref``) and sharded over `mesh` with the
    k-halo fast paths registered through `set_active_mesh`
    (``sharded``).  Returns a dict of lowered programs, their inputs
    and which k-halo paths the grid/mesh pair engages."""
    from cice4_tpu.grid import make_grid
    from cice4_tpu.io.forcing_data import AnalyticForcing
    from cice4_tpu.model import Model, ice_step
    from cice4_tpu.ops.evp_sharded import sharded_eligible
    from cice4_tpu.ops.remap import remap_sharded_eligible
    from cice4_tpu.parallel.mesh import set_active_mesh, shard_pytree
    from cice4_tpu.state import init_state

    dev0 = mesh.devices.flat[0]
    with jax.default_device(dev0):
        grid = make_grid(cfg, dtype=dtype)
        model = Model.create(cfg)
        state = init_state(cfg, grid, model.itd, dtype=dtype)
        forcing = AnalyticForcing(cfg, grid, dtype)(yday, sec)
    clock = (jnp.asarray(yday, dtype), jnp.asarray(sec, dtype))

    def step(s, g, f, y, t):
        return ice_step(model, s, g, f, y, t)

    ref_args = jax.device_put((state, grid, forcing) + clock, dev0)
    sh_args = tuple(shard_pytree(x, mesh) for x in (state, grid, forcing)) \
        + clock
    ref = jax.jit(step).lower(*ref_args)
    set_active_mesh(mesh)
    try:
        sharded = jax.jit(step).lower(*sh_args)
    finally:
        set_active_mesh(None)
    return dict(
        ref=ref, sharded=sharded, ref_args=ref_args, sh_args=sh_args,
        evp_khalo=bool(sharded_eligible(grid, mesh)),
        remap_khalo=bool(remap_sharded_eligible(grid, mesh, cfg.transport)))


def twin_compare(twin, ref_exe, sharded_exe):
    """Run both compiled programs, raise on guard violations, compare.

    Returns per-field error ``max|a-b| / max(|a|, 1)`` (``errors``),
    ``worst``, ``finite`` and the k-halo flags of `twin_lower`."""
    from cice4_tpu.guards import raise_on_violation

    ref_state, ref_fx = ref_exe(*twin["ref_args"])
    raise_on_violation(ref_fx.pop("_guards", {}))
    ref = {k: np.asarray(getattr(ref_state, k)) for k in TWIN_FIELDS}
    del ref_state, ref_fx
    out_state, out_fx = sharded_exe(*twin["sh_args"])
    raise_on_violation(out_fx.pop("_guards", {}))

    errors, finite = {}, True
    for name in TWIN_FIELDS:
        a = ref[name]
        b = np.asarray(getattr(out_state, name))
        finite = finite and bool(np.all(np.isfinite(b)))
        errors[name] = float(np.max(np.abs(a - b) / np.maximum(np.abs(a),
                                                               1.0)))
    return dict(errors=errors, worst=max(errors.values()), finite=finite,
                evp_khalo=twin["evp_khalo"],
                remap_khalo=twin["remap_khalo"])


def twin_check(cfg, mesh, dtype=jnp.float32, yday=80.0, sec=0.0):
    """`twin_lower`, compile, `twin_compare`."""
    twin = twin_lower(cfg, mesh, dtype, yday, sec)
    return twin_compare(twin, twin["ref"].compile(),
                        twin["sharded"].compile())
