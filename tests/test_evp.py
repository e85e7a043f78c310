"""EVP dynamics tests: free-drift balance, strength, strain diagnostics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cice4_tpu import constants as cn
from cice4_tpu.config import DynamicsConfig, gx3_config
from cice4_tpu.grid import make_rect_grid
from cice4_tpu.ops import evp as evp_mod
from cice4_tpu.ops.mechred_strength import ice_strength
from cice4_tpu.parallel.halo import BoundaryConditions
from cice4_tpu.state import make_itd_params, zeros_state


def _uniform_setup(ny=24, nx=32, aice_val=1.0, hice=2.0):
    cfg = gx3_config()
    bc = BoundaryConditions(ew="cyclic", ns="open")
    grid = make_rect_grid(nx, ny, bc, dx=20.0e3, dy=20.0e3,
                          land_edges=False, dtype=jnp.float64)
    s = zeros_state(cfg, grid, dtype=jnp.float64)
    ncat = cfg.domain.ncat
    aicen = jnp.zeros((ncat, ny, nx), jnp.float64).at[2].set(aice_val)
    vicen = aicen * hice
    s = s.replace(aicen=aicen, vicen=vicen)
    return cfg, grid, s


def _run_evp(cfg, grid, s, dyn, strairx=0.1, strairy=0.0, uocn=0.0,
             vocn=0.0, dt=3600.0, nsteps=1):
    ny, nx = grid.ny, grid.nx
    z = jnp.zeros((ny, nx), jnp.float64)
    aice = jnp.sum(s.aicen, 0)
    vice = jnp.sum(s.vicen, 0)
    vsno = jnp.sum(s.vsnon, 0)
    aice0 = jnp.maximum(1.0 - aice, 0.0)
    fn = jax.jit(lambda st: evp_mod.evp(
        st, grid, dyn, dt, aice, vice, vsno, st.aicen, st.vicen, aice0,
        z + uocn, z + vocn, z, z, z + strairx * aice, z + strairy * aice))
    for _ in range(nsteps):
        s, diag = fn(s)
    return s, diag


def test_free_drift_balance():
    """Interior velocity converges to the wind/drag/Coriolis balance of
    the reference momentum solve (``ice_dyn_evp.F90 stepu:1394-1427``):
    w*u - fm*v = taux and fm*u + w*v = 0, with w = rho_w Cd |u|."""
    cfg, grid, s = _uniform_setup()
    dyn = DynamicsConfig(ndte=120, kstrength=0, Pstar=0.0)  # zero strength
    taux = 0.1
    # iterate several dynamics steps so drag equilibrium is reached
    s, diag = _run_evp(cfg, grid, s, dyn, strairx=taux, nsteps=6)
    u = np.asarray(s.uvel)[10:-10, :]
    v = np.asarray(s.vvel)[10:-10, :]
    umass = cn.rhoi * 2.0  # kg/m^2 (aice=1, hice=2)
    fcor = np.asarray(grid.fcor)[10:-10, :]
    w = cn.dragio * cn.rhow * np.sqrt(u**2 + v**2)
    resx = taux - (w * u - fcor * umass * v)
    resy = -(fcor * umass * u + w * v)
    assert np.max(np.abs(resx)) < 0.02 * taux
    assert np.max(np.abs(resy)) < 0.02 * taux
    # Ekman-style rightward deflection in the northern hemisphere
    assert np.all(v < 0)
    assert np.all(u > 0.1)


def test_no_wind_no_motion():
    cfg, grid, s = _uniform_setup()
    dyn = DynamicsConfig(ndte=120)
    out, diag = _run_evp(cfg, grid, s, dyn, strairx=0.0)
    assert np.allclose(np.asarray(out.uvel), 0.0, atol=1e-12)
    assert np.allclose(np.asarray(out.vvel), 0.0, atol=1e-12)


def test_no_ice_masked():
    cfg, grid, s = _uniform_setup(aice_val=0.0)
    dyn = DynamicsConfig(ndte=120)
    out, diag = _run_evp(cfg, grid, s, dyn, strairx=0.5)
    assert np.allclose(np.asarray(out.uvel), 0.0)
    assert not bool(jnp.any(out.iceumask))


def test_convergent_wind_builds_stress():
    """Convergent wind field -> negative divergence, rdg_conv > 0."""
    cfg, grid, s = _uniform_setup(ny=32, nx=32)
    dyn = DynamicsConfig(ndte=120, kstrength=0)
    ny, nx = grid.ny, grid.nx
    x = (jnp.arange(nx) - nx / 2) / nx
    strairx = jnp.broadcast_to(-0.2 * jnp.tanh(4 * x)[None, :], (ny, nx))
    out, diag = _run_evp(cfg, grid, s, dyn, strairx=strairx)
    div = np.asarray(diag["divu"])[8:-8, 12:20]
    assert div.mean() < 0.0
    conv = np.asarray(diag["rdg_conv"])[8:-8, 12:20]
    assert conv.max() > 0.0
    # stress state developed
    assert float(jnp.max(jnp.abs(out.stressp))) > 0.0


def test_strength_hibler():
    dyn = DynamicsConfig(kstrength=0)
    ny = nx = 8
    aice = jnp.full((ny, nx), 0.9)
    vice = jnp.full((ny, nx), 1.8)
    aicen = jnp.stack([aice] + [jnp.zeros_like(aice)] * 4)
    vicen = jnp.stack([vice] + [jnp.zeros_like(vice)] * 4)
    mask = jnp.ones((ny, nx), bool)
    P = ice_strength(dyn, aice, vice, 1 - aice, aicen, vicen, mask)
    expect = dyn.Pstar * 1.8 * np.exp(-dyn.Cstar * 0.1)
    assert np.allclose(np.asarray(P), expect, rtol=1e-12)


def test_strength_rothrock_positive_and_increasing():
    dyn = DynamicsConfig(kstrength=1, krdg_partic=1, krdg_redist=1)
    ny = nx = 4
    itd = make_itd_params(gx3_config())

    def P_of(atot):
        an = jnp.asarray([0.3, 0.3, 0.2, 0.15, 0.05]) * atot
        hn = jnp.asarray([0.3, 1.0, 1.9, 3.4, 6.0])
        aicen = jnp.broadcast_to(an[:, None, None], (5, ny, nx))
        vicen = jnp.broadcast_to((an * hn)[:, None, None], (5, ny, nx))
        aice = jnp.sum(aicen, 0)
        vice = jnp.sum(vicen, 0)
        mask = jnp.ones((ny, nx), bool)
        return float(ice_strength(dyn, aice, vice, 1 - aice, aicen, vicen,
                                  mask)[0, 0])

    p_low, p_high = P_of(0.7), P_of(0.99)
    assert p_low > 0
    assert p_high > p_low  # compact ice is stronger


def _subcycle_args(grid, rng, icet, iceu, dtype):
    """Random subcycle inputs obeying evp_prep2's masked-zero contract:
    velocities and forcing zero off iceumask, stresses and strength zero
    off icetmask."""
    ny, nx = grid.ny, grid.nx

    def rand(lo, hi, shape=(ny, nx)):
        return jnp.asarray(rng.uniform(lo, hi, shape), dtype)

    strength = rand(0.0, 2.0e4) * icet
    aiu = rand(0.5, 1.0)
    uocn, vocn = rand(-0.2, 0.2), rand(-0.2, 0.2)
    waterx, watery = rand(-0.2, 0.2), rand(-0.2, 0.2)
    forcex, forcey = rand(-0.2, 0.2) * iceu, rand(-0.2, 0.2) * iceu
    umassdtei = rand(1.0, 60.0)
    fm = rand(-2.0, 2.0)
    uvel, vvel = rand(-0.3, 0.3) * iceu, rand(-0.3, 0.3) * iceu
    sp = rand(-1e3, 1e3, (4, ny, nx)) * icet
    sm = rand(-1e3, 1e3, (4, ny, nx)) * icet
    s12 = rand(-1e3, 1e3, (4, ny, nx)) * icet
    return (strength, icet, iceu, aiu, uocn, vocn, waterx, watery,
            forcex, forcey, umassdtei, fm, uvel, vvel, sp, sm, s12)


@pytest.mark.parametrize("ny", [64, 56, 48])
def test_subcycle_zero_off_ice_masks(ny):
    """After ndte subcycles, velocities and ocean/internal stresses are
    exactly zero off iceumask and the corner stresses exactly zero off
    icetmask, for polar ice bands with an ice-free middle.  Any kernel
    that skips ice-free tiles relies on this invariant."""
    cfg, grid, s = _uniform_setup(ny=ny, nx=128)
    dyn = DynamicsConfig(ndte=20)
    p = evp_mod.make_evp_params(dyn, 3600.0)
    nx = grid.nx
    rng = np.random.RandomState(7)
    row = np.arange(ny)[:, None] * np.ones((1, nx))
    band = (row < ny // 4) | (row >= ny - ny // 5)
    icet = jnp.asarray(band & (rng.rand(ny, nx) > 0.3))
    iceu = icet & (rng.rand(ny, nx) > 0.1)
    args = _subcycle_args(grid, rng, icet, iceu, jnp.float64)

    out = evp_mod._evp_subcycle_jnp(p, grid, *args)

    off_u = ~np.asarray(iceu)
    off_t = ~np.asarray(icet)
    for i, name in ((0, "uvel"), (1, "vvel"), (6, "strintx"),
                    (7, "strinty"), (8, "strocnx"), (9, "strocny")):
        v = np.asarray(out[i])
        assert np.all(v[off_u] == 0.0), name
    for i, name in ((2, "stressp"), (3, "stressm"), (4, "stress12")):
        v = np.asarray(out[i])
        assert np.all(v[:, off_t] == 0.0), name
    # the ice bands do move
    assert np.abs(np.asarray(out[0])[np.asarray(iceu)]).max() > 0.0


def test_subcycle_f32_matches_f64():
    """The f32 subcycle loop stays within 1e-4 of the f64 one, relative
    to each field's largest magnitude, after ndte=120 subcycles.  f32
    rounds each of the ~100 operations per subcycle at 6e-8 and the
    damped iteration accumulates that over 120 subcycles: the CPU
    backend gives 2e-6 (velocities) to 4e-5 (stress12, the smallest
    field).  1e-4 is the bound PARITY.md uses for f32-vs-f64 drift."""
    from cice4_tpu.grid import make_rect_grid as mk

    ny, nx = 32, 64
    bc = BoundaryConditions(ew="cyclic", ns="open")
    p = evp_mod.make_evp_params(DynamicsConfig(ndte=120), 3600.0)
    rng = np.random.RandomState(3)
    icet = jnp.asarray(rng.rand(ny, nx) > 0.2)
    iceu = icet & jnp.asarray(rng.rand(ny, nx) > 0.1)
    outs = {}
    for dtype in (jnp.float64, jnp.float32):
        grid = mk(nx, ny, bc, dx=20.0e3, dy=20.0e3, land_edges=False,
                  dtype=dtype)
        args = _subcycle_args(grid, np.random.RandomState(11), icet,
                              iceu, dtype)
        outs[dtype] = jax.jit(
            lambda *a, grid=grid: evp_mod._evp_subcycle_jnp(p, grid, *a)
        )(*args)
    ref, low = outs[jnp.float64], outs[jnp.float32]
    for i, name in enumerate(("uvel", "vvel", "stressp", "stressm",
                              "stress12")):
        a = np.asarray(ref[i])
        b = np.asarray(low[i], np.float64)
        assert low[i].dtype == jnp.float32, name
        err = np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30)
        assert err < 1e-4, (name, err)
