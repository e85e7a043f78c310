"""In-graph conservation guards: abort-with-coordinates.

The reference threads `l_stop/istop/jstop` through every physics
routine and calls `abort_ice` with the failing cell's indices when an
always-on invariant is violated (``ice_therm_vertical.F90
conservation_check_vthermo:4511-4613``, ``ice_itd.F90
column_conservation_check:1409-1473``, ``ice_mechred.F90
ridge_check:1788-1842``, ``mpi/ice_exit.F90 abort_ice:41-82``).

Here each check computes, in-graph, the violation count and the worst
cell's (j, i) — cheap reductions XLA fuses into the step — and packs
them into a small record that rides the step's flux dict
(`fluxes["_guards"]`).  The driver raises :class:`ConservationError`
with the cell coordinates when a record fires.  No host callbacks are
used, so nothing inside the step waits on the host: the guards run
identically on the CPU, on a GPU and under GSPMD sharding, and
the abort surfaces at the first host-side inspection of the step's
outputs, one dispatch behind the violation — the same failure model as
the reference's end-of-routine `abort_ice`.

Checks are enabled by `RunConfig.guards` (default on, as in the
reference; set False to shave the reductions off production runs).
"""

from __future__ import annotations

import jax.numpy as jnp

from cice4_tpu import constants as cn


class ConservationError(RuntimeError):
    """An always-on model invariant was violated (abort_ice)."""


def record(bad, err=None):
    """Pack a violation record: (count, j, i, worst-error).

    bad: boolean field with trailing (ny, nx) axes (leading axes are
    reduced with `any`); err: optional same-shape magnitude used to
    pick and report the worst cell.
    """
    if err is None:
        err = bad.astype(jnp.float32)
    # reduce any leading (category/layer) axes to the spatial plane
    while bad.ndim > 2:
        bad = jnp.any(bad, axis=0)
        err = jnp.max(err, axis=0)
    ny, nx = bad.shape
    masked = jnp.where(bad, err, -jnp.inf)
    flat = jnp.argmax(masked)
    return dict(count=jnp.sum(bad), j=flat // nx, i=flat % nx,
                worst=masked.reshape(-1)[flat])


def raise_on_violation(guards: dict):
    """Host-side: raise ConservationError if any packed record fired.

    `guards` is the `fluxes["_guards"]` dict of name -> record; values
    may still be device arrays (this forces them).
    """
    if not guards:
        return
    for name, rec in guards.items():
        if int(rec["count"]) > 0:
            raise ConservationError(
                f"{name}: {int(rec['count'])} cells violate; worst at "
                f"(j={int(rec['j'])}, i={int(rec['i'])}) "
                f"err={float(rec['worst']):.6e}")


def vthermo_tolerance(dtype) -> float:
    """Energy-flux error tolerance (W/m^2).  The reference's ferrmax
    (1e-3, ``ice_therm_vertical.F90:86``) assumes float64; in float32
    the einit/efinal difference alone carries O(eps * h * qi / dt)
    ~ 0.03 W/m^2 of representation noise, so the abort threshold is
    lifted well above it (real conservation bugs are O(10+))."""
    return 1.0e-3 if jnp.finfo(dtype).bits >= 64 else 0.5


def check_vthermo(dt, fsurfn, flatn, fswint, fhocnn, fsnow,
                  einit, efinal, has_ice):
    """``conservation_check_vthermo:4511-4613``: the per-category
    column energy change must equal the net flux into the column.
    (fsurf - flat excludes latent heat: the energy lost by the ice is
    gained by the vapor.)  Returns a violation record."""
    einp = (fsurfn - flatn + fswint - fhocnn - fsnow * cn.Lfresh) * dt
    ferr = jnp.abs(efinal - einit - einp) / dt
    bad = has_ice & (ferr > vthermo_tolerance(ferr.dtype))
    return record(bad, ferr)


def check_column_conservation(before, after, tmask):
    """``column_conservation_check:1409-1473``: a column total (e.g.
    sum of vicen over categories) must be unchanged by an ITD
    operation, to relative puny.  Returns a violation record."""
    eps = 1.0e-11 if jnp.finfo(before.dtype).bits >= 64 else 1.0e-6
    err = jnp.abs(after - before)
    bad = tmask & (err > eps * jnp.maximum(jnp.abs(before),
                                           jnp.abs(after)))
    return record(bad, err)


def check_ridge(asum, tmask, done):
    """``ridge_check:1788-1842``: after the ridging iteration the
    area fractions must sum to 1.  Returns a violation record."""
    eps = 1.0e-10 if jnp.finfo(asum.dtype).bits >= 64 else 1.0e-5
    err = jnp.abs(asum - 1.0)
    bad = tmask & (err > eps) & jnp.logical_not(done)
    return record(bad, err)
