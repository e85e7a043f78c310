"""Command-line interface: ``python -m cice4_tpu run [config.toml]``.

The runtime-config front end replacing the reference's `ice_in`
namelists + `comp_ice` build scripts (SURVEY §5-config): a TOML file
with sections matching the Config dataclasses, plus named presets.
"""

from __future__ import annotations

import argparse
import sys


def _load_config(args):
    from cice4_tpu.config import Config, config_from_dict, gx3_config

    if args.preset == "gx3":
        cfg = gx3_config()
    elif args.preset == "gx1":
        from cice4_tpu.config import gx1_config
        cfg = gx1_config()
    elif args.preset == "gx1-size":
        from cice4_tpu.config import gx1_size_config
        cfg = gx1_size_config()
    elif args.preset == "col":
        from cice4_tpu.config import col_config
        cfg = col_config()
    else:
        cfg = Config()
    if args.config:  # explicit config file overrides any preset
        import tomllib
        with open(args.config, "rb") as f:
            tree = tomllib.load(f)
        cfg = config_from_dict(tree)
    for kv in args.set or []:
        key, val = kv.split("=", 1)
        try:
            import ast
            val = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        cfg = cfg.with_values(**{key: val})
    return cfg


def main(argv=None):
    p = argparse.ArgumentParser(prog="cice4_tpu",
                                description="JAX sea-ice model")
    sub = p.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run the model")
    runp.add_argument("config", nargs="?", help="TOML config file")
    runp.add_argument("--preset", choices=["gx3", "gx1", "gx1-size", "col"],
                      default=None)
    runp.add_argument("--steps", type=int, default=None)
    runp.add_argument("--f64", action="store_true")
    runp.add_argument("--set", action="append", metavar="sec.key=val",
                      help="dotted config override, repeatable")

    benchp = sub.add_parser("bench", help="run the benchmark")

    args = p.parse_args(argv)

    if args.cmd == "bench":
        import bench
        bench.main()
        return 0

    import jax.numpy as jnp

    from cice4_tpu.compile_cache import enable_compile_cache
    from cice4_tpu.driver import IceModelRun

    enable_compile_cache()

    cfg = _load_config(args)
    dtype = jnp.float64 if args.f64 else jnp.float32
    if args.f64:
        import jax
        jax.config.update("jax_enable_x64", True)
    run = IceModelRun(cfg, dtype=dtype)
    run.initialize()
    run.run(args.steps)
    run.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
