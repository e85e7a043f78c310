"""`parallel.twin.twin_check` — the decomposition check behind
``chip_smoke.py --multi`` — on a 2x2 virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np

from cice4_tpu.config import gx1_size_config
from cice4_tpu.parallel.mesh import make_mesh
from cice4_tpu.parallel.twin import TWIN_FIELDS, TWIN_RTOL, twin_check


def test_twin_check_closed_grid_2x2():
    cfg = gx1_size_config().with_values(**{
        "domain.nx_global": 32, "domain.ny_global": 24,
        "dynamics.ndte": 120, "forcing.atm_data_type": "analytic"})
    mesh = make_mesh(devices=jax.devices()[:4])
    assert mesh.devices.shape == (2, 2)
    res = twin_check(cfg, mesh, dtype=jnp.float64)
    assert res["evp_khalo"] and res["remap_khalo"]
    assert res["finite"]
    assert set(res["errors"]) == set(TWIN_FIELDS)
    assert res["worst"] == max(res["errors"].values())
    assert np.isfinite(res["worst"]) and res["worst"] < TWIN_RTOL
