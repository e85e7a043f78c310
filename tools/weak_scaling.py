"""Weak-scaling measurement on the virtual CPU device mesh.

The reference's scaling story is MPI ranks over blocks (BASELINE.md:
>=85% weak-scaling target); the analogue here is spatial sharding
over a (y, x) mesh.  This harness measures the GSPMD program on an
N-virtual-device CPU mesh: the domain grows with the
device count (fixed work per device), and efficiency = T(1) / T(N).

CPU timings are rough (collectives are memcpys), but the run
validates that the sharded program's collective structure scales.

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       JAX_PLATFORMS=cpu python tools/weak_scaling.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
from cice4_tpu.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

import jax.numpy as jnp

from cice4_tpu.config import Config, DomainConfig, DynamicsConfig, \
    GridConfig, TransportConfig
from cice4_tpu.grid import make_grid
from cice4_tpu.io.forcing_data import AnalyticForcing
from cice4_tpu.model import Model, ice_step
from cice4_tpu.parallel.mesh import (init_distributed, make_mesh,
                                     set_active_mesh, shard_pytree)
from cice4_tpu.state import init_state

BASE_NY, BASE_NX = 96, 128   # per-device tile
NDTE = 40
NSTEPS = 4


def time_n(n_devices, fast_path=True):
    mesh = make_mesh(n_devices)
    py, px = mesh.devices.shape
    cfg = Config(
        domain=DomainConfig(nx_global=BASE_NX * px, ny_global=BASE_NY * py,
                            ew_boundary_type="cyclic",
                            ns_boundary_type="closed"),
        grid=GridConfig(grid_type="rectangular", lat_origin=62.0),
        dynamics=DynamicsConfig(ndte=NDTE),
        transport=TransportConfig(advection="remap"),
    )
    grid = make_grid(cfg, dtype=jnp.float32)
    model = Model.create(cfg)
    state = init_state(cfg, grid, model.itd, dtype=jnp.float32)
    forcing = AnalyticForcing(cfg, grid, jnp.float32)(1.0, 0.0)

    state = shard_pytree(state, mesh)
    grid_s = shard_pytree(grid, mesh)
    forcing = shard_pytree(forcing, mesh)
    # engage the k-halo sharded EVP subcycle (ops/evp_sharded.py)
    set_active_mesh(mesh if (fast_path and n_devices > 1) else None)

    @jax.jit
    def step(state, grid, forcing, yday, sec):
        return ice_step(model, state, grid, forcing, yday, sec)

    s, _ = step(state, grid_s, forcing, jnp.float32(1.0), jnp.float32(0.0))
    jax.block_until_ready(s.aicen)
    t0 = time.time()
    for k in range(NSTEPS):
        s, _ = step(s, grid_s, forcing, jnp.float32(1.0 + k),
                    jnp.float32(0.0))
    jax.block_until_ready(s.aicen)
    dt = (time.time() - t0) / NSTEPS
    set_active_mesh(None)
    cells = grid.nx * grid.ny
    return dt, cells


def main():
    init_distributed()
    avail = len(jax.devices())
    rows = []
    t1 = None
    for n in (1, 2, 4, 8):
        if n > avail:
            break
        dt, cells = time_n(n)
        if t1 is None:
            t1 = dt
        eff = t1 / dt
        rows.append(dict(devices=n, cells=cells, step_ms=dt * 1e3,
                         cellsteps_per_s=cells / dt,
                         weak_scaling_efficiency=eff))
        print(f"{n} devices: {cells:8d} cells  {dt * 1e3:8.1f} ms/step  "
              f"{cells / dt:.3e} cell-steps/s  eff {eff:5.2f}")
    # GSPMD-vs-fast-path comparison at the largest count
    n = rows[-1]["devices"]
    if n > 1:
        dt_g, cells = time_n(n, fast_path=False)
        rows.append(dict(devices=n, cells=cells, step_ms=dt_g * 1e3,
                         cellsteps_per_s=cells / dt_g,
                         mode="gspmd-per-subcycle-halos"))
        print(f"{n} devices (GSPMD halos): {dt_g * 1e3:8.1f} ms/step  "
              f"(k-halo fast path {rows[-2]['step_ms']:8.1f} ms)")
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
