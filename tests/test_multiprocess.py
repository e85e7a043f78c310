"""First REAL multi-process execution (VERDICT r4 item 5): two
localhost processes, 4 virtual CPU devices each, joined through
`jax.distributed` — the analogue of the reference's
`init_communicate` MPI world (``mpi/ice_communicate.F90:74-141``).

Covers: `init_distributed`, a full sharded model step over the
process boundary (checksummed against the same step run
single-process), and the `dump_restart_sharded` /
`load_restart_sharded` per-process-manifest round trip with
process_count()==2.

Launch line (what the test spawns, documented for manual use):

    CICE4_DISTRIBUTED=1 CICE4_COORDINATOR=127.0.0.1:<port> \
    CICE4_NUM_PROCESSES=2 CICE4_PROCESS_ID=<0|1> \
    JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
    python tests/_distributed_worker.py <out_dir>
"""

import os
import re
import socket
import subprocess
import sys

import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.timeout(600)
def test_two_process_step_and_sharded_restart(tmp_path):
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__),
                          "_distributed_worker.py")
    procs = []
    logs = []
    for i in range(2):
        env = dict(os.environ)
        env.pop("PYTEST_CURRENT_TEST", None)
        env.update(
            CICE4_DISTRIBUTED="1",
            CICE4_COORDINATOR=f"127.0.0.1:{port}",
            CICE4_NUM_PROCESSES="2",
            CICE4_PROCESS_ID=str(i),
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            JAX_COMPILATION_CACHE_DIR="",
        )
        log = open(tmp_path / f"worker{i}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, worker, str(tmp_path)],
            env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=540)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for log in logs:
            log.close()

    outs = [(tmp_path / f"worker{i}.log").read_text() for i in range(2)]
    if any("UNAVAILABLE" in o and "CHECKSUM" not in o for o in outs) \
            and any(p.returncode != 0 for p in procs):
        pytest.skip("jax.distributed rendezvous unavailable here:\n"
                    + outs[0][-800:])
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-3000:]}"

    # both processes computed identical checksums over the SHARDED run
    sums = {}
    for o in outs:
        m = re.search(r"CHECKSUM (\d) (.+)", o)
        assert m, o[-500:]
        sums[m.group(1)] = m.group(2)
    assert sums["0"] == sums["1"], sums

    # and they match the single-process (8 local devices) run
    expect = _single_process_checksums()
    got = dict(kv.split("=") for kv in sums["0"].split())
    for k, v in expect.items():
        assert abs(float(got[k]) - v) <= 1e-9 * max(abs(v), 1.0), \
            (k, got[k], v)

    assert "RESTART_OK" in outs[0]


def _single_process_checksums():
    import jax
    import jax.numpy as jnp

    from cice4_tpu.config import (Config, DomainConfig, DynamicsConfig,
                                  GridConfig, TransportConfig)
    from cice4_tpu.forcing import default_forcing
    from cice4_tpu.grid import make_grid
    from cice4_tpu.model import Model, ice_step
    from cice4_tpu.state import init_state

    cfg = Config(
        domain=DomainConfig(nx_global=32, ny_global=16,
                            ew_boundary_type="cyclic",
                            ns_boundary_type="open"),
        grid=GridConfig(grid_type="rectangular", lat_origin=66.0),
        dynamics=DynamicsConfig(ndte=8),
        transport=TransportConfig(advection="remap"),
    )
    grid = make_grid(cfg, dtype=jnp.float64)
    model = Model.create(cfg)
    state = init_state(cfg, grid, model.itd, dtype=jnp.float64)
    f = default_forcing(grid.ny, grid.nx, jnp.float64)
    x = jnp.arange(grid.nx, dtype=jnp.float64)[None, :]
    y = jnp.arange(grid.ny, dtype=jnp.float64)[:, None]
    uatm = 4.0 + 3.0 * jnp.sin(2 * jnp.pi * x / grid.nx) + 0.0 * y
    vatm = 1.0 + 2.0 * jnp.cos(2 * jnp.pi * y / grid.ny) + 0.0 * x
    f = f.replace(uatm=uatm, vatm=vatm,
                  wind=jnp.sqrt(uatm**2 + vatm**2))
    out, _ = jax.jit(lambda s: ice_step(model, s, grid, f, 80.0, 0.0)
                     )(state)
    return dict(aice=float(jnp.sum(out.aicen)),
                vice=float(jnp.sum(out.vicen)),
                u2=float(jnp.sum(out.uvel**2)),
                e=float(jnp.sum(out.eicen)))
