"""Model lifecycle driver: initialize / run / finalize.

Equivalent of the standalone driver ``drivers/cice4/CICE.F90:64-94`` +
``CICE_InitMod.F90 cice_init:124-199`` + ``CICE_RunMod.F90
CICE_Run:94-146``: builds grid/state/forcing, owns the model clock,
steps the jitted model, emits diagnostics on `diagfreq`, accumulates
history means, and writes restart dumps on `dumpfreq`.
"""

from __future__ import annotations

import dataclasses
import os
import time as _time

import jax
import jax.numpy as jnp

from cice4_tpu.calendar import Calendar
from cice4_tpu.config import Config
from cice4_tpu.diagnostics import (find_points, format_diags,
                                   format_points, init_mass_diags,
                                   point_diags, runtime_diags)
from cice4_tpu.forcing import Forcing
from cice4_tpu.guards import raise_on_violation
from cice4_tpu.grid import Grid, make_grid
from cice4_tpu.io.forcing_data import make_forcing_provider
from cice4_tpu.io.history import History
from cice4_tpu.io.restart import dump_restart, load_restart, read_pointer
from cice4_tpu.model import Model, ice_step
from cice4_tpu.state import State, init_state
from cice4_tpu.timers import Timers


class IceModelRun:
    """One configured model run (the `CICE_Initialize/Run/Finalize`
    3-call lifecycle, ``drivers/cice4/CICE.F90:80-92``)."""

    def __init__(self, cfg: Config, dtype=jnp.float32, log=print):
        self.cfg = cfg
        self.dtype = dtype
        self.log = log
        self.timers = Timers()
        self.grid: Grid | None = None
        self.state: State | None = None
        self.model: Model | None = None
        self.calendar: Calendar | None = None
        self._step = None
        self._diag = None
        self._restore = None
        self._pending_guards = None
        self.history = None

    # -- initialize ---------------------------------------------------------

    def initialize(self, state: State | None = None):
        cfg = self.cfg
        with self.timers("Init"):
            self.grid = make_grid(cfg, dtype=self.dtype)
            self.model = Model.create(cfg)
            self.calendar = Calendar(dt=cfg.run.dt,
                                     year_init=cfg.run.year_init,
                                     days_per_year=cfg.run.days_per_year)
            self.forcing_provider = make_forcing_provider(cfg, self.grid,
                                                          self.dtype)
            if state is not None:
                self.state = state
            elif cfg.run.runtype == "continue":
                path = read_pointer(cfg.run.pointer_file)
                template = init_state(cfg, self.grid, self.model.itd,
                                      dtype=self.dtype)
                self.state, header = load_restart(path, template)
                self.calendar.istep = header["istep"]
                self.calendar.time = header["time"]
                self.calendar._recompute()
                self.log(f"restarted from {path} @ step {header['istep']}")
            else:
                self.state = init_state(cfg, self.grid, self.model.itd,
                                        dtype=self.dtype)

            model = self.model
            grid = self.grid

            @jax.jit
            def _step(state, forcing, yday, sec):
                return ice_step(model, state, grid, forcing, yday, sec)

            self._step = _step
            dt = float(cfg.run.dt)
            update_ocn_f = bool(cfg.thermo.update_ocn_f)
            calc_Tsfc = bool(cfg.thermo.calc_Tsfc)
            self._diag = jax.jit(
                lambda s, fx, f, di: runtime_diags(
                    s, grid, fluxes=fx, forcing=f, init_diag=di, dt=dt,
                    update_ocn_f=update_ocn_f, calc_Tsfc=calc_Tsfc))
            self._initdiag = jax.jit(lambda s: init_mass_diags(s, grid))
            self._points = (find_points(grid, cfg.run.latpnt_lonpnt)
                            if cfg.run.print_points else None)
            # initial ocean fields from climatology (init_forcing_ocn)
            ocn = getattr(self.forcing_provider, "ocn", None)
            if ocn is not None and ocn.available \
                    and cfg.run.runtype != "continue" and state is None:
                sss0, _tf0, sst0 = ocn.initial_fields(self.calendar.month)
                if sst0 is not None:
                    self.state = self.state.replace(sst=sst0)
            # regional ice restoring toward the initial state
            # (ice_restoring.F90; restore_ice flag)
            self._restore = None
            if cfg.forcing.restore_ice:
                from cice4_tpu.ops.restoring import (boundary_band_mask,
                                                     restore_ice)
                band = boundary_band_mask(self.grid)
                ref_state = self.state
                trest = float(cfg.forcing.trestore)

                @jax.jit
                def _restore(state):
                    return restore_ice(state, ref_state, band,
                                       cfg.run.dt, trest)
                self._restore = _restore
            self.history = History(
                grid, histfreq=cfg.run.histfreq,
                histfreq_n=cfg.run.histfreq_n, avg=cfg.run.hist_avg,
                directory=cfg.run.history_dir, itd=model.itd,
                fmt=cfg.run.history_format)
        return self

    # -- run ----------------------------------------------------------------

    def run(self, npt: int | None = None, on_diag=None):
        """Run npt steps (default cfg.run.npt).

        on_diag: optional callback ``(istep, diags: dict) -> None``
        invoked at every diagnostic interval with the structured
        runtime_diags values — the public hook for harnesses that
        collect trajectories (e.g. the gx3-month parity run) instead
        of re-implementing this loop.
        """
        cfg = self.cfg
        cal = self.calendar
        npt = npt if npt is not None else cfg.run.npt
        t_wall0 = _time.time()
        for _ in range(npt):
            diag_step = (cfg.run.diagfreq
                         and (cal.istep + 1) % cfg.run.diagfreq == 0)
            with self.timers("Forcing"):
                f = self.forcing_provider(cal.yday, cal.sec, cal=cal,
                                          state=self.state)
                if hasattr(self.forcing_provider, "ocean_update"):
                    self.state = self.forcing_provider.ocean_update(
                        self.state, cal, cfg.run.dt)
            if diag_step:
                # start-of-step totals for the budget-closure errors
                # (init_mass_diags, ice_diagnostics.F90:853-927)
                init_diag = self._initdiag(self.state)
            with self.timers("Step"):
                self.state, fluxes = self._step(
                    self.state, f, jnp.asarray(cal.yday, self.dtype),
                    jnp.asarray(cal.sec, self.dtype))
            # abort-with-coordinates (guards.py): inspect the PREVIOUS
            # step's violation records — it has already completed, so
            # this costs no pipeline stall — then queue this step's
            if self._pending_guards:
                raise_on_violation(self._pending_guards)
            self._pending_guards = fluxes.pop("_guards", None)
            if self._restore is not None:
                self.state = self._restore(self.state)
            cal.advance()
            with self.timers("History"):
                self.history.accumulate(self.state, fluxes, forcing=f,
                                        yday=cal.yday, dt=cfg.run.dt)
                for p in self.history.write_due(cal):
                    self.log(f"wrote history {p}")
            if diag_step:
                with self.timers("Diags"):
                    d = self._diag(self.state, fluxes, f, init_diag)
                    jax.block_until_ready(d)
                    self.log(format_diags(cal.istep, d))
                    if on_diag is not None:
                        on_diag(cal.istep,
                                {k: float(v) for k, v in d.items()})
                    if self._points:
                        pd = point_diags(self.state, self.grid, fluxes,
                                         f, cfg.run.dt, self._points)
                        self.log(format_points(pd))
            if cal.write_flag(cfg.run.dumpfreq, cfg.run.dumpfreq_n):
                with self.timers("ReadWrite"):
                    self.write_restart()
        jax.block_until_ready(self.state.aicen)
        if self._pending_guards:
            raise_on_violation(self._pending_guards)
            self._pending_guards = None
        wall = _time.time() - t_wall0
        self.log(f"ran {npt} steps in {wall:.2f} s "
                 f"({npt * self.grid.nx * self.grid.ny / max(wall, 1e-9):.3e}"
                 " cell-steps/s)")
        return self.state

    # -- finalize -----------------------------------------------------------

    def write_restart(self):
        cfg = self.cfg
        cal = self.calendar
        path = os.path.join(cfg.run.restart_dir,
                            f"iced.{cal.idate}.{int(cal.sec):05d}.npz")
        dump_restart(self.state, path, cal.istep, cal.time,
                     pointer_file=cfg.run.pointer_file)
        self.log(f"wrote restart {path}")
        return path

    def finalize(self):
        self.log(self.timers.report())
        return self.timers
