"""Reference-parity run: the canonical 744-step gx3 January month.

Mirrors the reference's shipped test problem (`comp_ice:37-41`, log
`ice.log.Linux.LANL.coyote`): gx3 100x116 displaced-pole POP grid,
dt=3600 s, ndte=120, 744 hourly steps (January), remap advection,
ridging, ocean mixed layer, diagnostics every 24 steps.

Differences vs the reference run (documented in PARITY.md): the
reference starts from a January restart dump (`iced_gx3_v4.0_
kcatbound0`) and reads 1997 NCAR-bulk forcing — neither file ships
with the source, so this run starts from the default initial state
(`ice_init.F90 set_state_var:921-1195`) under the idealized seasonal
forcing and compares hemispheric *magnitudes* (sanity bands) plus
budget-closure errors, which must hold regardless of forcing.

Usage: python tools/run_gx3_month.py [npt] [--f32] [--json out.json]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

from cice4_tpu.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

import jax.numpy as jnp


def run_month(npt=744, dtype=None, log=print, diagfreq=24):
    """Run the gx3 month; returns the list of diagnostics dicts
    (one per diag interval, each with 'istep')."""
    if dtype is None:
        if jax.default_backend() == "cpu":
            jax.config.update("jax_enable_x64", True)
            dtype = jnp.float64
        else:
            dtype = jnp.float32
    from cice4_tpu.config import gx3_config
    from cice4_tpu.driver import IceModelRun

    cfg = gx3_config().with_values(**{
        "dynamics.ndte": 120,
        "run.diagfreq": diagfreq,
        "run.npt": npt,
        "run.histfreq": ("x",) * 5,
        "run.dumpfreq": "x",
        # January start as the reference month run
        "run.year_init": 1997,
    })
    rows = []

    def capture(msg):
        log(msg)

    run = IceModelRun(cfg, dtype=dtype, log=capture)
    run.initialize()

    def on_diag(istep, d):
        d = dict(d)
        d["istep"] = istep
        rows.append(d)

    run.run(npt, on_diag=on_diag)
    return rows


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    npt = int(args[0]) if args else 744
    dtype = jnp.float32 if "--f32" in sys.argv else None
    import time
    t0 = time.time()
    rows = run_month(npt=npt, dtype=dtype)
    wall = time.time() - t0
    print(f"# {npt} gx3 steps in {wall:.1f} s", file=sys.stderr)
    if "--json" in sys.argv:
        out = sys.argv[sys.argv.index("--json") + 1]
        with open(out, "w") as fh:
            json.dump(rows, fh)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
