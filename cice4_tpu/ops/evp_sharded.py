"""Sharded EVP fast path: k-wide halos, one exchange per k subcycles.

The reference exchanges uvel/vvel halos after EVERY one of the ndte
(=120) subcycles (``ice_dyn_evp.F90:397-402``) — the `Bound` timer
showed ~25% of total runtime spent waiting on those exchanges even on
Infiniband (``ice.log.Linux.LANL.coyote:795``; SURVEY §7 hard-part 1).
Under GSPMD the jnp fallback reproduces exactly that pattern: every
`jnp.roll` in the subcycle body becomes a collective-permute, so a
120-subcycle loop issues ~240 tiny permutes per dynamics step.

This module instead runs the subcycle loop inside ``shard_map`` with a
k-wide ghost ring (nghost=1 in the reference, but the math permits
trading halo width for comm rounds): each exchange refreshes H ghost
cells, each subcycle's 3x3 stencil consumes one ring, so H-1 subcycles
run back-to-back with zero communication and the number of exchange
rounds drops from ndte to ceil(ndte/(H-1)) (120 -> 12 at the default
H=11).  The exchanged volume is similar (wider strips, fewer
messages); the LATENCY — the quantity that killed the reference — is
cut ~10x.  Physics per subcycle is bit-identical: the body calls the
SAME `_stress_update` / `_stepu` as the jnp path, just on locally
padded blocks with plain rolls instead of boundary-aware shifts.

Supported boundaries: cyclic/open/closed EW+NS and the production
U-fold (``tripole``, since round 5): the top mesh row fills its north
ghosts from the x-MIRRORED shard via an intra-row `ppermute` with
column reversal and per-field sign/permutation laws (velocities are
NE-corner vectors, the stress stacks swap corners under the
180-degree rotation, the stencil-coefficient pairs cyp/cym and
cxp/cxm swap and negate), then computes stress REDUNDANTLY in the
fold ghost zone — which reproduces the global jnp path's paired
str8 fold bit-exactly (the discrete operators are equivariant under
the fold; verified in `tests/test_sharded_tripole.py`).  The T-fold
(``tripoleT``) still falls back to GSPMD.  Requires block sizes
divisible by the mesh.
"""

from __future__ import annotations

from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

DEFAULT_H = 11          # ghost width -> H-1 subcycles per exchange


class PadNbr:
    """Neighbor shifts on a locally padded block: plain rolls, no
    boundary masks — ghosts supply correct neighbor values and the
    roll's wrap garbage only ever lands in the outermost ghost ring,
    which the shrinking-halo schedule never consumes."""

    def e(self, f, loc=None, ftype=None):
        return jnp.roll(f, -1, axis=-1)

    def w(self, f, loc=None, ftype=None):
        return jnp.roll(f, 1, axis=-1)

    def n(self, f, loc=None, ftype=None):
        return jnp.roll(f, -1, axis=-2)

    def s(self, f, loc=None, ftype=None):
        return jnp.roll(f, 1, axis=-2)

    def ne(self, f, loc=None, ftype=None):
        return self.n(self.e(f))


def _exchange(a, H, px, py, ew_cyclic, ns_cyclic, xi, yi):
    """Refresh all four H-wide ghost bands of the padded block `a`
    (trailing dims (byp, bxp)) from the neighboring shards.

    Standard two-phase exchange: x-strips first, then full-width
    y-strips (corners ride the second phase).  Non-cyclic global edges
    zero their ghosts (the halo module's open/closed semantics; for a
    tripole NS boundary `_exchange_batch` overwrites the top mesh
    row's north ghosts with the mirrored-shard fold afterwards)."""
    if px > 1:
        east_strip = a[..., H:-H, -2 * H:-H]
        west_strip = a[..., H:-H, H:2 * H]
        fwd = [(i, (i + 1) % px) for i in range(px)]
        bwd = [(i, (i - 1) % px) for i in range(px)]
        from_w = jax.lax.ppermute(east_strip, "x", fwd)
        from_e = jax.lax.ppermute(west_strip, "x", bwd)
        a = a.at[..., H:-H, :H].set(from_w)
        a = a.at[..., H:-H, -H:].set(from_e)
    elif ew_cyclic:
        a = a.at[..., H:-H, :H].set(a[..., H:-H, -2 * H:-H])
        a = a.at[..., H:-H, -H:].set(a[..., H:-H, H:2 * H])
    if not ew_cyclic:
        a = a.at[..., :, :H].set(
            jnp.where(xi == 0, 0.0, a[..., :, :H]))
        a = a.at[..., :, -H:].set(
            jnp.where(xi == px - 1, 0.0, a[..., :, -H:]))
    if py > 1:
        north_strip = a[..., -2 * H:-H, :]
        south_strip = a[..., H:2 * H, :]
        fwd = [(j, (j + 1) % py) for j in range(py)]
        bwd = [(j, (j - 1) % py) for j in range(py)]
        from_s = jax.lax.ppermute(north_strip, "y", fwd)
        from_n = jax.lax.ppermute(south_strip, "y", bwd)
        a = a.at[..., :H, :].set(from_s)
        a = a.at[..., -H:, :].set(from_n)
    elif ns_cyclic:
        a = a.at[..., :H, :].set(a[..., -2 * H:-H, :])
        a = a.at[..., -H:, :].set(a[..., H:2 * H, :])
    if not ns_cyclic:
        a = a.at[..., :H, :].set(
            jnp.where(yi == 0, 0.0, a[..., :H, :]))
        a = a.at[..., -H:, :].set(
            jnp.where(yi == py - 1, 0.0, a[..., -H:, :]))
    return a


def _exchange_round(a, H, px, py, ew_cyclic, ns_cyclic, xi, yi,
                    tripole):
    """Batched per-round exchange of the (14, byp, bxp) subcycle carry
    stack [u, v, stressp(4), stressm(4), stress12(4)]: ONE set of
    collectives per round regardless of field count (4 permutes + 1
    fold permute on tripole) — the reference's message aggregation,
    and the countable collective structure `tests` asserts.

    Plane fold laws (tripole): rows 0-1 are NE-corner vectors (sign
    flip, U-point row map); rows 2-13 are the three stress corner
    stacks (center row map, 180-degree corner swap [2,3,0,1])."""
    specs = _ROUND_SPECS if tripole else None
    return _exchange_batch(a, H, px, py, ew_cyclic, ns_cyclic, xi, yi,
                           specs)


# per-plane fold laws as (source_plane, is_center_rowmap, sign):
# the 14-plane round stack [u, v, sp(4), sm(4), s12(4)] — velocities
# are NE-corner vectors, stress corners swap under the 180-deg fold
_ROUND_SPECS = (
    [0, 1, 4, 5, 2, 3, 8, 9, 6, 7, 12, 13, 10, 11],
    [False, False] + [True] * 12,
    [-1.0, -1.0] + [1.0] * 12,
)


def _exchange_batch(a, H, px, py, ew_cyclic, ns_cyclic, xi, yi,
                    fold_specs=None):
    """Generic batched exchange of a (P, byp, bxp) plane stack with
    per-plane tripole fold laws.

    fold_specs: None for non-tripole grids, else (src, is_center,
    sign) sequences of length P: ghost plane p is built from source
    plane src[p] with the center (T-scalar) or NE-corner (U-point) row
    map and the given sign.  One fold `ppermute` covers every plane."""
    a = _exchange(a, H, px, py, ew_cyclic, ns_cyclic, xi, yi)
    if fold_specs is None:
        return a
    src, is_center, sign = fold_specs
    byp = a.shape[-2]
    by = byp - 2 * H
    # one slab carries both row maps: mirror padded rows [by-1, by+H)
    slab = a[..., by - 1:by + H, :]
    if px > 1:
        pairs = [(i, px - 1 - i) for i in range(px)]
        slab = jax.lax.ppermute(slab, "x", pairs)
    # ghost r=1..H <- slab index H-r+1 (center) / H-r (necorner),
    # then column reversal (+1 roll for the U-point map); the roll's
    # single wrapped column lands in the outermost ghost ring, which
    # the shrinking-halo schedule never consumes
    g = jnp.arange(H)
    center_rows = jnp.flip(slab[..., H - g, :], axis=-1)
    nec_rows = jnp.roll(jnp.flip(slab[..., H - 1 - g, :], axis=-1),
                        -1, axis=-1)
    srci = jnp.asarray(src)
    isc = jnp.asarray(is_center)[:, None, None]
    sgn = jnp.asarray(sign, a.dtype)[:, None, None]
    ghost = sgn * jnp.where(isc, center_rows[srci], nec_rows[srci])
    return a.at[..., -H:, :].set(
        jnp.where(yi == py - 1, ghost, a[..., -H:, :]))


def evp_subcycle_sharded(p, grid, mesh, strength, icetmask, iceumask,
                         aiu, uocn, vocn, waterx, watery,
                         forcex, forcey, umassdtei, fm,
                         uvel, vvel, stressp, stressm, stress12,
                         H: int = DEFAULT_H):
    """ndte subcycles with k-halo exchanges under shard_map.

    Same signature/returns as `_evp_subcycle_jnp` (evp.py): returns
    (uvel, vvel, stressp, stressm, stress12, diag, strintx, strinty,
    strocnx, strocny)."""
    from cice4_tpu.ops.evp import _stepu, _stress_update

    py, px = mesh.devices.shape
    ew_cyclic = grid.bc.ew == "cyclic"
    ns_cyclic = grid.bc.ns == "cyclic"
    tripole = grid.bc.ns in ("tripole", "tripoleT")
    tfold = grid.bc.ns == "tripoleT"
    # the exchange copies H-wide strips of INTERIOR, so H can't exceed
    # the local block; small blocks just exchange more often.  The
    # tripole fold's NE-corner slab additionally reads one row south of
    # the top physical block rows (two for the T-fold).
    H = min(H, grid.ny // py, grid.nx // px)
    if tripole:
        H = min(H, grid.ny // py - (2 if tfold else 1))
    ksub = H - 1
    ndte = p.ndte
    # rounds of ksub subcycles + remainder; final subcycle runs
    # separately for the ridging diagnostics
    nfull = (ndte - 1) // ksub
    rem = (ndte - 1) - nfull * ksub

    geom_names = ("cyp", "cxp", "cym", "cxm", "dxt", "dyt",
                  "dxhy", "dyhx", "tinyarea", "uarear")
    geom_vals = tuple(getattr(grid, n) for n in geom_names)

    spec2 = P("y", "x")
    spec3 = P(None, "y", "x")
    in_specs = ((spec2,) * len(geom_vals)        # geometry
                + (spec2,) * 12                  # per-step constants
                + (spec2, spec2)                 # uvel, vvel
                + (spec3, spec3, spec3))         # stresses

    dtype = uvel.dtype

    # one-time constants stack: geometry (order = geom_names: cyp,
    # cxp, cym, cxm swap PAIRWISE and negate under the fold; dxhy/dyhx
    # are odd; dxt/dyt/tinyarea even T scalars; uarear a U scalar)
    # then the 12 per-step constants
    if tripole:
        const_specs = (
            # cyp<-cym, cxp<-cxm, cym<-cyp, cxm<-cxp (negated), then
            # dxt, dyt, dxhy(-), dyhx(-), tinyarea, uarear
            [2, 3, 0, 1, 4, 5, 6, 7, 8, 9,
             10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21],
            [True] * 9 + [False]                 # geometry row maps
            + [True, True, False, False] + [False] * 8,
            [-1.0, -1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0, 1.0]
            + [1.0, 1.0, 1.0, 1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0,
               1.0, 1.0],
        )
    else:
        const_specs = None

    def run(*args):
        g = dict(zip(geom_names, args[:len(geom_names)]))
        (strength, icet, iceu, aiu, uocn, vocn, waterx, watery,
         forcex, forcey, umassdtei, fm, uvel, vvel,
         stressp, stressm, stress12) = args[len(geom_names):]
        xi = jax.lax.axis_index("x")
        yi = jax.lax.axis_index("y")

        def pad2(a):
            return jnp.pad(a.astype(dtype) if a.dtype == jnp.bool_
                           else a, ((H, H), (H, H)))

        def pad3(a):
            return jnp.pad(a, ((0, 0), (H, H), (H, H)))

        # constants: pad + fill ghosts once, ONE batched exchange
        cstack = jnp.stack(
            [pad2(g[n]) for n in geom_names]
            + [pad2(v) for v in
               (strength, icet.astype(dtype), iceu.astype(dtype),
                aiu, uocn, vocn, waterx, watery, forcex, forcey,
                umassdtei, fm)], axis=0)
        cstack = _exchange_batch(cstack, H, px, py, ew_cyclic,
                                 ns_cyclic, xi, yi, const_specs)
        geom = SimpleNamespace(
            **{n: cstack[i] for i, n in enumerate(geom_names)})
        (strength, icetf, iceuf, aiu, uocn, vocn, waterx, watery,
         forcex, forcey, umassdtei, fm) = (cstack[len(geom_names) + i]
                                           for i in range(12))
        icet = icetf > 0.5
        iceu = iceuf > 0.5
        uvel, vvel = pad2(uvel), pad2(vvel)
        stressp, stressm, stress12 = (pad3(stressp), pad3(stressm),
                                      pad3(stress12))
        nbr = PadNbr()

        def subcycle(carry):
            uvel, vvel, sp, sm, s12 = carry
            sp, sm, s12, str8, _d = _stress_update(
                p, geom, nbr, strength, icet, uvel, vvel, sp, sm, s12)
            uvel, vvel, *_ = _stepu(
                p, geom, nbr, iceu, aiu, str8, uocn, vocn, waterx,
                watery, forcex, forcey, umassdtei, fm, uvel, vvel)
            return uvel, vvel, sp, sm, s12

        def ex_round(carry):
            uvel, vvel, sp, sm, s12 = carry
            stack = jnp.concatenate(
                [uvel[None], vvel[None], sp, sm, s12], axis=0)
            stack = _exchange_round(stack, H, px, py, ew_cyclic,
                                    ns_cyclic, xi, yi, tripole)
            return (stack[0], stack[1], stack[2:6], stack[6:10],
                    stack[10:14])

        def round_k(k, carry):
            carry = ex_round(carry)
            return jax.lax.fori_loop(
                0, k, lambda _, c: subcycle(c), carry)

        carry = (uvel, vvel, stressp, stressm, stress12)
        carry = jax.lax.fori_loop(
            0, nfull, lambda _, c: round_k(ksub, c), carry)
        if rem:
            carry = round_k(rem, carry)

        # final subcycle with ridging diagnostics
        uvel, vvel, sp, sm, s12 = ex_round(carry)
        sp, sm, s12, str8, d = _stress_update(
            p, geom, nbr, strength, icet, uvel, vvel, sp, sm, s12)
        uvel, vvel, strintx, strinty, strocnx, strocny = _stepu(
            p, geom, nbr, iceu, aiu, str8, uocn, vocn, waterx, watery,
            forcex, forcey, umassdtei, fm, uvel, vvel)

        core2 = lambda a: a[..., H:-H, H:-H]  # noqa: E731
        diag = dict(div_sum=core2(jnp.sum(d["div"], 0)),
                    delta_sum=core2(jnp.sum(d["delta"], 0)),
                    ten_sum=core2(jnp.sum(d["ten"], 0)),
                    shr_sum=core2(jnp.sum(d["shr"], 0)),
                    prs_sig=core2(d["prs_sig"]))
        return (core2(uvel), core2(vvel), core2(sp), core2(sm),
                core2(s12), diag,
                core2(strintx), core2(strinty),
                core2(strocnx), core2(strocny))

    diag_spec = dict(div_sum=spec2, delta_sum=spec2, ten_sum=spec2,
                     shr_sum=spec2, prs_sig=spec2)
    out_specs = ((spec2, spec2, spec3, spec3, spec3, diag_spec)
                 + (spec2,) * 4)
    fn = shard_map(run, mesh=mesh, in_specs=in_specs,
                   out_specs=out_specs)
    return fn(*geom_vals, strength, icetmask, iceumask, aiu, uocn,
              vocn, waterx, watery, forcex, forcey, umassdtei, fm,
              uvel, vvel, stressp, stressm, stress12)


def sharded_eligible(grid, mesh) -> bool:
    """Fast-path eligibility: an active multi-device mesh, block sizes
    divisible by the mesh shape.  The ACCESS-OM production U-fold
    (``tripole``) is supported since round 5 via the mirrored-shard
    fold exchange; the rarer T-fold (``tripoleT``) still falls back to
    GSPMD (fold-line storage duplication of T rows is not enforced)."""
    import os
    if os.environ.get("CICE4_NO_SHARDED_EVP"):
        return False
    if mesh is None:
        return False
    py, px = mesh.devices.shape
    if py * px <= 1:
        return False
    if grid.bc.ns == "tripoleT":
        return False
    if grid.bc.ns == "tripole" and grid.ny // py < 3:
        return False  # fold slab needs a row south of the top block
    return grid.ny % py == 0 and grid.nx % px == 0