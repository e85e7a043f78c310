"""Runoff regridding: masked, conserving gaussian filter.

JAX port of the COSIMA coupled driver's runoff smoother
(``drivers/access-om/gaussian_filter.F90``): river runoff received on
coastal points is spread over nearby ocean cells with a gaussian
kernel; weights clobbered by the land mask are redistributed evenly
over the unmasked part of each window so the field's total is
conserved (``convolve:69-135`` mask branch).

The reference convolves with explicit loops over a 3x3
reflect-tiled copy (``tile_and_reflect:40-68``); here the same
operation is four `lax.conv` calls on a symmetric-padded array —
dense MXU work, jit/vmap/shard-friendly.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def gaussian_kernel(sigma: float, truncate: float = 4.0):
    """(2r+1, 2r+1) normalized gaussian weights, r = int(truncate*sigma
    + 0.5) (``gaussian_kernel:10-39``; the factor 2 in the reference's
    unnormalized kernel cancels in the normalization)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    k = np.exp(-0.5 * (xx**2 + yy**2) / sigma**2)
    return jnp.asarray(k / k.sum())


def _conv_same(a, kernel):
    """'Same'-size 2D correlation with symmetric (reflect-with-edge)
    padding — the boundary semantics of the reference's 3x3 flip
    tiling (one reflection per side)."""
    r = kernel.shape[0] // 2
    ap = jnp.pad(a, ((r, r), (r, r)), mode="symmetric")
    out = jax.lax.conv_general_dilated(
        ap[None, None].astype(kernel.dtype),
        kernel[None, None],
        window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))
    return out[0, 0]


def convolve(field, kernel, mask=None):
    """Gaussian-filtered field (``convolve:69-135``).

    mask: 1 on active cells, 0 on masked; masked cells pass through
    unchanged, and each window's masked weight is redistributed evenly
    over its unmasked cells so that a uniform field stays uniform and
    the filter conserves the masked-area integral."""
    kernel = jnp.asarray(kernel, field.dtype)
    if mask is None:
        return _conv_same(field, kernel)
    m = jnp.asarray(mask, field.dtype)
    ones = jnp.ones_like(kernel)
    a = _conv_same(field * m, kernel)            # sum w * x * m
    clobber = _conv_same(1.0 - m, kernel)        # sum (1-m) * w
    count = jnp.maximum(_conv_same(m, ones), 1.0)  # sum m (unweighted)
    boxsum = _conv_same(field * m, ones)         # sum x * m
    out = a + clobber * boxsum / count
    return jnp.where(m > 0.0, out, field)


def regrid_runoff(runof, tmask, sigma: float = 2.0):
    """Spread coastal runoff over nearby ocean with the masked
    gaussian filter (the driver applies this to the received runoff
    field before handing it to the ocean; `cpl_forcing_handler` runoff
    path)."""
    return convolve(runof, gaussian_kernel(sigma), tmask)
