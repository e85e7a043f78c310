"""GA-factored remap contraction vs the legacy per-category one.

Both paths evaluate the same triangle-quadrature sums (the GA path
reassociates them through the category-independent geometric
accumulators, see `remap._geom_accumulators`, and reconstructs with
streamed neighbor shifts), so on the f64 CPU backend they must agree to
tight roundoff.  The default (GA) path must also conserve mass.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cice4_tpu.config import Config, DomainConfig, DynamicsConfig, \
    GridConfig, TransportConfig
from cice4_tpu.grid import make_grid
from cice4_tpu.model import Model
from cice4_tpu.ops.remap import transport_remap
from cice4_tpu.state import init_state


def _setup(ny=24, nx=32):
    cfg = Config(
        domain=DomainConfig(nx_global=nx, ny_global=ny,
                            ew_boundary_type="cyclic",
                            ns_boundary_type="closed"),
        grid=GridConfig(grid_type="rectangular", lat_origin=62.0),
        dynamics=DynamicsConfig(ndte=10),
        transport=TransportConfig(advection="remap"),
    )
    grid = make_grid(cfg, dtype=jnp.float64)
    model = Model.create(cfg)
    state = init_state(cfg, grid, model.itd, dtype=jnp.float64)
    x = jnp.arange(nx)[None, :] / nx
    y = jnp.arange(ny)[:, None] / ny
    state = state.replace(
        uvel=0.3 * jnp.sin(6.28 * x) * jnp.cos(3.14 * y) * grid.umask,
        vvel=0.2 * jnp.cos(6.28 * x) * jnp.sin(3.14 * y) * grid.umask)
    return cfg, grid, state


@pytest.mark.parametrize("order", [1, 2, 3])
def test_ga_matches_legacy_contraction(order, monkeypatch):
    cfg, grid, state = _setup()
    dt = 3600.0
    s_ga, a0_ga = transport_remap(state, grid, dt, order)
    monkeypatch.setenv("CICE4_REMAP_GA", "0")
    s_ref, a0_ref = transport_remap(state, grid, dt, order)
    np.testing.assert_allclose(np.asarray(a0_ga), np.asarray(a0_ref),
                               rtol=1e-9, atol=1e-12)
    for name in ("aicen", "vicen", "vsnon", "tsfcn", "eicen", "esnon"):
        a = np.asarray(getattr(s_ref, name))
        b = np.asarray(getattr(s_ga, name))
        np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-10,
                                   err_msg=name)
    for name in s_ref.trcrn:
        np.testing.assert_allclose(np.asarray(s_ga.trcrn[name]),
                                   np.asarray(s_ref.trcrn[name]),
                                   rtol=1e-8, atol=1e-10, err_msg=name)


def test_default_path_conserves_mass():
    cfg, grid, state = _setup()
    dt = 3600.0
    s_new, _ = transport_remap(state, grid, dt, 2)
    for f in ("aicen", "vicen", "vsnon"):
        before = np.sum(np.asarray(getattr(state, f)) *
                        np.asarray(grid.tarea))
        after = np.sum(np.asarray(getattr(s_new, f)) *
                       np.asarray(grid.tarea))
        assert abs(after - before) <= 1e-9 * max(abs(before), 1.0), f
