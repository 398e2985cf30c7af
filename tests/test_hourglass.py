"""Soundness and tightness of the apex-aware (hourglass) shadow cull
(kernels/tiled._visibility_hourglass) vs a per-ray slab oracle.

Shadow rays all pass through one light point; the hourglass test bounds
p(t) = (1-t)o + t(o+d) by two lines per axis in two t-branches (t<=1 /
t>=1, the no-max-t quirk).  Soundness contract: every block any REAL ray
can touch (t >= 0, unbounded) must stay visible.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from simple_raytracer.kernels.tiled import (_visibility,
                                                _visibility_hourglass)


def _ray_block_oracle(o, d, bmin, bmax):
    """Per-ray slab test, t in [0, inf) -> visible [R, NB] bool (f64)."""
    oo = o[:, None, :].astype(np.float64)
    dd = d[:, None, :].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(np.abs(dd) > 0, 1.0 / dd, np.inf)
    t1 = (bmin[None] - oo) * inv
    t2 = (bmax[None] - oo) * inv
    tlo = np.minimum(t1, t2)
    thi = np.maximum(t1, t2)
    par = dd == 0
    inside = (oo >= bmin[None]) & (oo <= bmax[None])
    tlo = np.where(par, np.where(inside, -np.inf, np.inf), tlo)
    thi = np.where(par, np.where(inside, np.inf, -np.inf), thi)
    enter = np.maximum(tlo.max(-1), 0.0)
    exit_ = thi.min(-1)
    return (exit_ >= enter) & np.isfinite(enter)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hourglass_sound_and_tighter(seed):
    rng = np.random.default_rng(seed)
    TILE = 64
    NT = 8
    NB = 128
    # tiles of surface points with one light apex per... one global light
    light = rng.uniform(-50, 50, 3).astype(np.float32)
    o = rng.uniform(-100, 100, (NT * TILE, 3)).astype(np.float32)
    # cluster each tile's origins (surface patches)
    centers = rng.uniform(-100, 100, (NT, 3)).astype(np.float32)
    o = (centers[:, None] + rng.uniform(-5, 5, (NT, TILE, 3))
         ).reshape(-1, 3).astype(np.float32)
    d = light[None] - o
    ext = rng.uniform(1, 20, (NB, 3)).astype(np.float32)
    bmin = rng.uniform(-120, 120, (NB, 3)).astype(np.float32)
    bmax = bmin + ext

    vis_h, tlo_h, n = _visibility_hourglass(
        jnp.asarray(o), jnp.asarray(d), TILE,
        jnp.asarray(bmin), jnp.asarray(bmax))
    vis_i, _, _ = _visibility(
        jnp.asarray(o), jnp.asarray(d), TILE,
        jnp.asarray(bmin), jnp.asarray(bmax))
    vis_h = np.asarray(vis_h)
    vis_i = np.asarray(vis_i)

    oracle = _ray_block_oracle(o, d, bmin, bmax)
    need = oracle.reshape(n, TILE, NB).any(1)

    # sound: every truly reachable block stays visible
    assert not (need & ~vis_h).any(), "hourglass culled a needed block"
    # never looser than the interval test by construction goal; allow a
    # tiny epsilon-margin slack (<= 2% extra blocks)
    extra = (vis_h & ~vis_i).sum()
    assert extra <= 0.02 * vis_i.sum() + 2, (extra, vis_i.sum())
    # and strictly tighter overall on apex-converging rays
    assert vis_h.sum() <= vis_i.sum()


def test_hourglass_entry_bounds_lower_bound_true_entry():
    """The packed front-to-back bound must LOWER-bound every real entry t."""
    rng = np.random.default_rng(3)
    TILE = 32
    NB = 64
    light = np.array([10., -40., 30.], np.float32)
    o = (np.array([[-60., 20., 5.]], np.float32)
         + rng.uniform(-4, 4, (TILE, 3)).astype(np.float32))
    d = light[None] - o
    ext = rng.uniform(1, 15, (NB, 3)).astype(np.float32)
    bmin = rng.uniform(-80, 80, (NB, 3)).astype(np.float32)
    bmax = bmin + ext

    vis_h, tlo_h, n = _visibility_hourglass(
        jnp.asarray(o), jnp.asarray(d), TILE,
        jnp.asarray(bmin), jnp.asarray(bmax))
    vis_h = np.asarray(vis_h)[0]
    tlo_h = np.asarray(tlo_h)[0]

    # per-ray true entry times (f64 oracle)
    oo = o[:, None, :].astype(np.float64)
    dd = d[:, None, :].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(np.abs(dd) > 0, 1.0 / dd, np.inf)
    t1 = (bmin[None] - oo) * inv
    t2 = (bmax[None] - oo) * inv
    tlo = np.minimum(t1, t2)
    thi = np.maximum(t1, t2)
    enter = np.maximum(tlo.max(-1), 0.0)
    exit_ = thi.min(-1)
    hit = (exit_ >= enter) & np.isfinite(enter)          # [TILE, NB]
    true_entry = np.where(hit, enter, np.inf).min(0)     # [NB]

    for b in range(NB):
        if hit[:, b].any():
            assert vis_h[b]
            assert tlo_h[b] <= true_entry[b] + 1e-3, (
                b, tlo_h[b], true_entry[b])
