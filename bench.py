"""Benchmark: full-model throughput on the canonical gx3 configuration.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ...,
"vs_baseline": N}.

Baseline: the reference CICE 4.1 gx3 log (`ice.log.Linux.LANL.coyote:
782`) — 100x116 x 744 steps / 60.75 s on 4 MPI ranks = 1.42e5
cell-steps/s aggregate, i.e. 3.55e4 cell-steps/s per rank (serial
baseline).  `vs_baseline` is the per-chip speedup over the serial
Fortran rank.
"""

import json
import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "")

import jax

from cice4_tpu.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

import jax.numpy as jnp

SERIAL_BASELINE = 1.42e5 / 4.0  # cell-steps/s per reference rank


def main():
    from cice4_tpu.config import gx1_config, gx3_config
    from cice4_tpu.forcing import default_forcing
    from cice4_tpu.grid import make_grid
    from cice4_tpu.io.forcing_data import AnalyticForcing
    from cice4_tpu.model import Model, ice_step
    from cice4_tpu.state import init_state

    which = os.environ.get("BENCH_CONFIG", "gx1")
    if which == "access025":
        # ACCESS-OM 0.25-degree production scale (1440x1080 tripole,
        # ``bld/config.nci.access-om.1440x1080:8-15``)
        from cice4_tpu.config import access_om_config
        cfg = access_om_config(1440, 1080)
    elif which == "gx1":
        cfg = gx1_config()
    else:
        cfg = gx3_config()
    grid = make_grid(cfg, dtype=jnp.float32)
    model = Model.create(cfg)
    state = init_state(cfg, grid, model.itd, dtype=jnp.float32)
    provider = AnalyticForcing(cfg, grid, jnp.float32)
    forcing = provider(1.0, 0.0)

    @jax.jit
    def step(state, forcing, yday, sec):
        return ice_step(model, state, grid, forcing, yday, sec)

    # warmup / compile
    t0 = time.time()
    s, fluxes = step(state, forcing, jnp.float32(1.0), jnp.float32(0.0))
    jax.block_until_ready(s.aicen)
    compile_s = time.time() - t0
    print(f"# compile+first step: {compile_s:.1f} s", file=sys.stderr)

    # timed steps (forcing held fixed on device; host loop only)
    nsteps = 48
    t0 = time.time()
    for k in range(nsteps):
        s, fluxes = step(s, forcing, jnp.float32(1.0 + k / 24.0),
                         jnp.float32((k % 24) * 3600.0))
    jax.block_until_ready(s.aicen)
    wall = time.time() - t0

    cells = grid.nx * grid.ny
    rate = cells * nsteps / wall
    print(f"# {nsteps} steps in {wall:.3f} s on {jax.devices()[0].platform}",
          file=sys.stderr)
    print(json.dumps({
        "metric": f"{which} full-model cell-steps/s (1 chip)",
        "value": rate,
        "unit": "cell-steps/s",
        "vs_baseline": rate / SERIAL_BASELINE,
    }))


if __name__ == "__main__":
    main()
