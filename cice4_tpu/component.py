"""ESMF-style gridded-component wrapper around the model lifecycle.

JAX equivalent of ``drivers/esmf/CICE_ComponentMod.F90:58-214``
(`CICE_SetServices` registering `CICE_Initialize` / `CICE_Run` /
`CICE_Finalize` entry points) plus the coupled run loops of
``drivers/esmf/CICE_RunMod.F90`` and ``drivers/access-cm/CICE_RunMod.F90``.

The ESMF machinery (GridComp objects, ESMF_State, clocks) maps onto
plain Python: a component object with `initialize / run / finalize`
methods, import/export *states* as dicts of named (ny, nx) arrays, and
the host's own clock (the component advances its internal calendar by
`n` coupling steps per `run` call).  `set_services()` returns the entry
-point registry the way `CICE_SetServices` fills the ESMF dispatch
table.

Two field-set flavors:

- ``flavor="om"`` — ACCESS-OM (``drivers/access-om/cpl_interface.F90``):
  10 a2i + 7 o2i in, 15 i2o + 1 i2a out, model computes its own surface
  fluxes (`calc_Tsfc=T`).
- ``flavor="cm"`` — ACCESS-CM (``drivers/access-cm/cpl_interface.F90``):
  UM supplies per-category top/bottom melt fluxes; the ice runs the
  prescribed-flux thermo (`calc_Tsfc=F`), see
  :mod:`cice4_tpu.coupling_cm`.
"""

from __future__ import annotations

import jax.numpy as jnp

from cice4_tpu import coupling, coupling_cm
from cice4_tpu.config import Config
from cice4_tpu.driver import IceModelRun


class IceComponent:
    """One coupled ice component (ESMF GridComp equivalent).

    Lifecycle (``CICE_ComponentMod.F90 CICE_SetServices:58-214``)::

        comp = IceComponent(cfg, flavor="om")
        comp.initialize()
        export = comp.run({"a2i": {...}, "o2i": {...}}, n_steps=4)
        comp.finalize()
    """

    def __init__(self, cfg: Config, flavor: str = "om",
                 dtype=jnp.float32, log=print,
                 gfdl_surface_flux: bool = False):
        if flavor not in ("om", "cm"):
            raise ValueError(f"unknown coupling flavor {flavor!r}")
        if flavor == "cm" and cfg.thermo.calc_Tsfc:
            raise ValueError("ACCESS-CM coupling requires "
                             "thermo.calc_Tsfc=False (prescribed-flux "
                             "thermo; cpl_forcing_handler.F90 "
                             "set_sbc_ice:436-519)")
        self.cfg = cfg
        self.flavor = flavor
        self.dtype = dtype
        # cpl_parameters.F90:54 — open-water fluxes from the GFDL
        # Monin-Obukhov package (default .true. in the reference OM)
        self.gfdl_surface_flux = gfdl_surface_flux
        self.log = log
        self.runner: IceModelRun | None = None
        self._boundary = None

    # -- ESMF_SETINIT / SETRUN / SETFINAL dispatch table ---------------------

    def set_services(self) -> dict:
        """Entry-point registry (`CICE_SetServices` analogue)."""
        return {"init": self.initialize, "run": self.run,
                "finalize": self.finalize}

    # -- entry points --------------------------------------------------------

    def initialize(self, state=None):
        """`CICE_Initialize` (``drivers/esmf/CICE_InitMod.F90``): build
        grid/state/step; the initial Forcing comes from the configured
        provider and is then overwritten by coupler imports."""
        self.runner = IceModelRun(self.cfg, dtype=self.dtype,
                                  log=self.log).initialize(state=state)
        cal = self.runner.calendar
        f0 = self.runner.forcing_provider(cal.yday, cal.sec, cal=cal,
                                          state=self.runner.state)
        self._boundary = coupling.CouplerBoundary(
            f0, tmask=self.runner.grid.tmask,
            gfdl_surface_flux=self.gfdl_surface_flux)
        self._last_fluxes = None
        return self

    def run(self, import_state: dict | None = None,
            n_steps: int = 1) -> dict:
        """`CICE_Run` for one coupling interval: fold the import state
        into the forcing, advance `n_steps` model steps, and return the
        export state (``drivers/esmf/CICE_RunMod.F90 CICE_Run`` +
        the from_atm/from_ocn/into_ocn/into_atm exchange of
        ``cpl_interface.F90``)."""
        r = self.runner
        bnd = self._boundary
        import_state = import_state or {}
        a2i = import_state.get("a2i")
        o2i = import_state.get("o2i")

        if self.flavor == "om":
            if a2i:
                bnd.recv_atm(a2i)
            if o2i:
                bnd.recv_ocn(o2i)
                r.state = bnd.apply_ocean_state(r.state)
        else:
            if a2i:
                bnd.forcing = coupling_cm.from_atm_cm(
                    bnd.forcing, a2i, r.state.aicen)
            if o2i:
                # iceform melt limit (cpl_forcing_handler.F90
                # set_sbc_ice MOM section): cap the negative frzmlt
                bnd.forcing, upd = coupling_cm.from_ocn_cm(
                    bnd.forcing, o2i, meltlimit=-1000.0)
                r.state = r.state.replace(**upd)

        cal = r.calendar
        fluxes = None
        for _ in range(n_steps):
            r.state, fluxes = r._step(r.state, bnd.forcing,
                                      jnp.asarray(cal.yday),
                                      jnp.asarray(cal.sec))
            cal.advance()
            r.history.accumulate(r.state, fluxes)
            for p in r.history.write_due(cal):
                self.log(f"wrote history {p}")
        self._last_fluxes = fluxes

        if self.flavor == "om":
            export = {"i2o": bnd.send_ocn(fluxes, r.state),
                      "i2a": bnd.send_atm(fluxes, r.state)}
        else:
            export = {"i2o": coupling.into_ocn(fluxes, r.state,
                                               bnd.forcing),
                      "i2a": coupling_cm.into_atm_cm(r.state)}
        return export

    def finalize(self):
        """`CICE_Finalize` (``drivers/esmf/CICE_FinalMod.F90``)."""
        return self.runner.finalize()
