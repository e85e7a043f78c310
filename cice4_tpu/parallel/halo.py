"""Neighbor access with boundary conditions — the halo-exchange equivalent.

The reference implements halos as explicit MPI message schedules over a
block decomposition (``mpi/ice_boundary.F90:153-1417``: `ice_HaloCreate`
precomputes send/recv lists, `ice_HaloUpdate` packs/sends/unpacks and
applies the tripole fold).  Here none of that machinery exists as user
code: fields are dense global ``(..., ny, nx)`` arrays sharded over a
device mesh, stencil neighbor access is written in global view with
``jnp.roll``/slicing, and XLA's SPMD partitioner inserts the actual
collective-permutes (NCCL over NVLink between GPUs).  What remains of "halo logic" is purely the
*physical* boundary condition of the global domain, implemented here:

* ``cyclic``   — wraparound (roll is already correct)
* ``closed``   — ghost value 0 (land beyond the edge)
* ``open``     — ghost value 0 at runtime, same as closed: the reference
  `ice_HaloUpdate` leaves unreachable ghosts at the zero fill value for
  both; only *grid* fields get `ice_HaloExtrapolate`
  (``mpi/ice_boundary.F90:6262-6378``), which the grid loader applies
  itself at init
* ``tripole``  — Arctic fold across the top row (U-fold), with index
  reversal and a sign flip for vector/angle fields
  (``mpi/ice_boundary.F90`` tripole sections)
* ``tripoleT`` — T-fold variant

All functions operate on arrays whose last two axes are ``(y, x)`` and
are shape-preserving, trace-once, and GSPMD-friendly (no data-dependent
control flow).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from cice4_tpu.constants import FieldLoc, FieldType


@dataclasses.dataclass(frozen=True)
class BoundaryConditions:
    """Physical boundary condition of the global domain edges."""

    ew: str = "cyclic"   # cyclic | open | closed
    ns: str = "open"     # cyclic | open | closed | tripole | tripoleT


def _edge_fix_last_row(f, bc_ns, loc, ftype):
    """Values to place in the row that wrapped around from the bottom
    when shifting north (i.e. the ghost row beyond j = ny-1)."""
    if bc_ns == "cyclic":
        return None  # roll already correct
    if bc_ns in ("closed", "open"):
        return jnp.zeros_like(f[..., -1:, :])
    if bc_ns in ("tripole", "tripoleT"):
        return _tripole_ghost_north(f, bc_ns, loc, ftype)
    raise ValueError(f"unknown ns boundary {bc_ns!r}")


def _tripole_ghost_north(f, bc_ns, loc, ftype):
    """Ghost row north of the top physical row for a tripole fold.

    For the U-fold grid (``tripole``) the top row of U points lies on
    the fold; the grid point north of T cell (ny-1, i) is T cell
    (ny-1, nx-1-i) viewed upside-down.  Vector components flip sign.
    Index maps follow ``mpi/ice_boundary.F90`` (tripole unpacking):

    * center:    ghost(i) = s * f[ny-1, nx-1-i]
    * NE corner: ghost(i) = s * f[ny-2, (nx-2-i) mod nx]   (U-fold)
    * N face:    ghost(i) = s * f[ny-2, nx-1-i]
    * E face:    ghost(i) = s * f[ny-1, (nx-2-i) mod nx]

    For the T-fold grid (``tripoleT``) the fold runs through the top row
    of T points; center points use row ny-2 reversed.
    """
    sign = -1.0 if ftype in (FieldType.VECTOR, FieldType.ANGLE) else 1.0
    nx = f.shape[-1]
    rev = jnp.arange(nx - 1, -1, -1)         # nx-1-i
    rev_u = jnp.mod(jnp.arange(nx - 2, -2, -1), nx)  # (nx-2-i) mod nx
    if bc_ns == "tripole":
        if loc == FieldLoc.CENTER:
            row = f[..., -1, :][..., rev]
        elif loc == FieldLoc.NE_CORNER:
            row = f[..., -2, :][..., rev_u]
        elif loc == FieldLoc.N_FACE:
            row = f[..., -2, :][..., rev]
        else:  # E_FACE
            row = f[..., -1, :][..., rev_u]
    else:  # tripoleT
        if loc == FieldLoc.CENTER:
            row = f[..., -2, :][..., rev]
        elif loc == FieldLoc.NE_CORNER:
            row = f[..., -1, :][..., rev_u]
        elif loc == FieldLoc.N_FACE:
            row = f[..., -1, :][..., rev]
        else:  # E_FACE
            row = f[..., -2, :][..., rev_u]
    return (sign * row)[..., None, :]


def _set_last_row(shifted, fix):
    if fix is None:
        return shifted
    return jnp.concatenate([shifted[..., :-1, :], fix], axis=-2)


def _set_first_row(shifted, fix):
    if fix is None:
        return shifted
    return jnp.concatenate([fix, shifted[..., 1:, :]], axis=-2)


def _set_last_col(shifted, fix):
    if fix is None:
        return shifted
    return jnp.concatenate([shifted[..., :, :-1], fix], axis=-1)


def _set_first_col(shifted, fix):
    if fix is None:
        return shifted
    return jnp.concatenate([fix, shifted[..., :, 1:]], axis=-1)


def nbr_e(f, bc: BoundaryConditions, loc=FieldLoc.CENTER,
          ftype=FieldType.SCALAR):
    """out[j, i] = f[j, i+1] with the EW boundary condition applied."""
    s = jnp.roll(f, -1, axis=-1)
    if bc.ew == "cyclic":
        return s
    if bc.ew in ("closed", "open"):
        return _set_last_col(s, jnp.zeros_like(f[..., :, -1:]))
    raise ValueError(f"unknown ew boundary {bc.ew!r}")


def nbr_w(f, bc: BoundaryConditions, loc=FieldLoc.CENTER,
          ftype=FieldType.SCALAR):
    """out[j, i] = f[j, i-1]."""
    s = jnp.roll(f, 1, axis=-1)
    if bc.ew == "cyclic":
        return s
    if bc.ew in ("closed", "open"):
        return _set_first_col(s, jnp.zeros_like(f[..., :, :1]))
    raise ValueError(f"unknown ew boundary {bc.ew!r}")


def nbr_n(f, bc: BoundaryConditions, loc=FieldLoc.CENTER,
          ftype=FieldType.SCALAR):
    """out[j, i] = f[j+1, i] with the NS boundary condition applied."""
    s = jnp.roll(f, -1, axis=-2)
    return _set_last_row(s, _edge_fix_last_row(f, bc.ns, loc, ftype))


def nbr_s(f, bc: BoundaryConditions, loc=FieldLoc.CENTER,
          ftype=FieldType.SCALAR):
    """out[j, i] = f[j-1, i].  The southern edge of every supported grid
    is effectively closed (Antarctica for global grids): ghost is 0 for
    `closed`/`open`/`tripole*`, wrapped for `cyclic`."""
    s = jnp.roll(f, 1, axis=-2)
    if bc.ns == "cyclic":
        return s
    return _set_first_row(s, jnp.zeros_like(f[..., :1, :]))


def nbr_ne(f, bc, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
    return nbr_n(nbr_e(f, bc, loc, ftype), bc, loc, ftype)


def nbr_nw(f, bc, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
    return nbr_n(nbr_w(f, bc, loc, ftype), bc, loc, ftype)


def nbr_se(f, bc, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
    return nbr_s(nbr_e(f, bc, loc, ftype), bc, loc, ftype)


def nbr_sw(f, bc, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
    return nbr_s(nbr_w(f, bc, loc, ftype), bc, loc, ftype)
