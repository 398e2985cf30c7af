"""Window walks: the nearest-hit and any-hit kernels and their plain twins.

Each program of a kernel owns one ray TILE (``tile`` consecutive rays of a
coherent bundle) and walks that tile's plan (kernels/tiled.py:cull): a
front-to-back list of triangle WINDOWS (``window`` consecutive triangles in
BVH order), or a contiguous window range for tiles whose list overflowed.
Per window it loads the triangles' rows from the geometry operand
(accel/prepared.py:pack_geom_np) and runs Möller–Trumbore in float32
elementwise — [tile, chunk] pairs at a time, the same operations in the same
order as the jnp oracle (ops/intersect.py:moller_trumbore), so the walk and
the oracle differ only where the compiler contracts a multiply-add.

The nearest walk stops once every ray of the tile holds a hit closer than
the next list entry's conservative entry bound (the planner's ``bound16``);
the any-hit walk stops once every ray is occluded.

The kernels are Pallas on the Triton route (``backend="triton"``), compiled
for a CUDA GPU.  ``interpret=True`` runs them in the Pallas interpreter; only
the CPU tests pass it.  ``nearest_reference`` / ``anyhit_reference`` are the
same walks over the same plan in plain jnp: the tests compare the kernels
with them, and the chip check times XLA's build of them against the kernels.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..utils import pad_rays

PLAN_AUX = 8          # plan columns 0-7: lo, range_cnt, list_cnt, use_list, 0..
RAY_ROWS = 8          # ray operand rows: ox oy oz dx dy dz self_obj pad
GEOM_ROWS = 10        # geometry rows: p1 xyz, e1 xyz, e2 xyz, object id
_NO_INDEX = 0x7FFFFFFF


def pack_rays(origin, direction, tile: int, self_obj=None):
    """Flat rays [R,3] (+ self object ids [R]) -> (rays [RAY_ROWS, Rp] f32,
    R).  Pads R up to a tile multiple with the last ray."""
    o, d, R = pad_rays(origin, direction, tile)
    Rp = o.shape[0]
    if self_obj is None:
        so = jnp.zeros((Rp,), jnp.float32)
    else:
        so = self_obj.astype(jnp.float32)
        if Rp > R:
            so = jnp.concatenate([so, jnp.broadcast_to(so[-1:], (Rp - R,))])
    rows = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], so,
            jnp.zeros((Rp,), jnp.float32)]
    return jnp.stack(rows, axis=0).astype(jnp.float32), R


def _mt(o, d, tri, eps):
    """Möller–Trumbore t for rays o/d (3 arrays each, [..., 1]-shaped) against
    triangle rows ``tri`` (9 arrays p1 xyz, e1 xyz, e2 xyz, [1, ...]-shaped).
    The operation order of ops/intersect.py:moller_trumbore; misses -> +inf."""
    ox, oy, oz = o
    dx, dy, dz = d
    p1x, p1y, p1z, e1x, e1y, e1z, e2x, e2y, e2z = tri
    px = dy * e2z - dz * e2y                 # pvec = cross(d, e2)
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / det
    tx = ox - p1x                            # tvec = o - p1
    ty = oy - p1y
    tz = oz - p1z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y                 # qvec = cross(tvec, e1)
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = ((jnp.abs(det) >= eps) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t >= 0.0))
    return jnp.where(valid, t, jnp.inf)


def _plan_reader(plan_ref, window: int):
    """(count, k -> first triangle of the k-th window, list flag,
    k -> entry bound bits) for the tile's plan row (see tiled.cull)."""
    cap = plan_ref.shape[-1] - PLAN_AUX
    lo = plan_ref[0, 0]
    use_list = plan_ref[0, 3] == 1
    cnt = jnp.where(use_list, plan_ref[0, 2], plan_ref[0, 1])

    def entry(k):
        return plan_ref[0, PLAN_AUX + jnp.minimum(k, cap - 1)]

    def start(k):
        return jnp.where(use_list, entry(k) & 0xFFFF, lo + k) * window

    def bound_bits(k):
        # the entry's truncated f32 bound as int bits: non-negative floats
        # order as their bit patterns, so int compares stand for float ones
        return entry(k) & jnp.int32(-65536)
    return cnt, start, use_list, bound_bits


def _ray_rows(ray_ref):
    o = tuple(ray_ref[r, :][:, None] for r in range(3))
    d = tuple(ray_ref[3 + r, :][:, None] for r in range(3))
    return o, d


def _tri_rows(geom_ref, first, chunk):
    return tuple(geom_ref[r, pl.ds(first, chunk)][None, :]
                 for r in range(GEOM_ROWS))


def _nearest_kernel(plan_ref, ray_ref, geom_ref, t_ref, idx_ref, *,
                    window: int, chunk: int, eps: float):
    o, d = _ray_rows(ray_ref)
    tile = o[0].shape[0]
    cnt, start, use_list, bound_bits = _plan_reader(plan_ref, window)
    lane = jax.lax.broadcasted_iota(jnp.int32, (tile, chunk), 1)

    def cond(state):
        k, _, _, done = state
        return (k < cnt) & ~done

    def body(state):
        k, best_t, best_i, _ = state
        first = start(k)
        for c in range(0, window, chunk):
            rows = _tri_rows(geom_ref, first + c, chunk)
            t = _mt(o, d, rows[:9], eps)                      # [tile, chunk]
            tmin = jnp.min(t, axis=1)
            arg = jnp.min(jnp.where(t == tmin[:, None], lane, chunk), axis=1)
            ids = first + c + arg
            # ties go to the lowest triangle id, as in the oracle's argmin
            better = (tmin < best_t) | ((tmin == best_t) & (ids < best_i))
            best_t = jnp.where(better, tmin, best_t)
            best_i = jnp.where(better, ids, best_i)
        worst = jnp.max(jax.lax.bitcast_convert_type(best_t, jnp.int32))
        done = use_list & (worst < bound_bits(k + 1))
        return k + 1, best_t, best_i, done

    init = (jnp.int32(0), jnp.full((tile,), jnp.inf, jnp.float32),
            jnp.full((tile,), _NO_INDEX, jnp.int32), jnp.bool_(False))
    _, best_t, best_i, _ = jax.lax.while_loop(cond, body, init)
    t_ref[...] = best_t
    idx_ref[...] = jnp.where(best_t < jnp.inf, best_i, -1)


def _anyhit_kernel(plan_ref, ray_ref, geom_ref, hit_ref, *, window: int,
                   chunk: int, eps: float, no_max_t: bool):
    o, d = _ray_rows(ray_ref)
    self_obj = ray_ref[6, :][:, None]
    tile = o[0].shape[0]
    cnt, start, _, _ = _plan_reader(plan_ref, window)

    def cond(state):
        k, _, done = state
        return (k < cnt) & ~done

    def body(state):
        k, found, _ = state
        first = start(k)
        for c in range(0, window, chunk):
            rows = _tri_rows(geom_ref, first + c, chunk)
            t = _mt(o, d, rows[:9], eps)
            occ = (t < jnp.inf) & (rows[9] != self_obj)
            if not no_max_t:
                occ = occ & (t <= 1.0)
            found = jnp.maximum(found, jnp.max(occ.astype(jnp.int32), axis=1))
        return k + 1, found, jnp.min(found) > 0

    init = (jnp.int32(0), jnp.zeros((tile,), jnp.int32), jnp.bool_(False))
    _, found, _ = jax.lax.while_loop(cond, body, init)
    hit_ref[...] = found


def _check_backend(interpret: bool) -> None:
    backend = jax.default_backend()
    if interpret and backend == "gpu":
        raise ValueError("interpret=True is for the CPU tests; on a GPU the "
                         "walk kernels are compiled")
    if not interpret and backend != "gpu":
        raise RuntimeError(
            f"the walk kernels compile only for a CUDA GPU (backend "
            f"{backend!r}); render with mode='bvh' or 'bruteforce' here")


def _call(kernel, plan, rays, geom, out_shape, tile, num_warps, interpret):
    _check_backend(interpret)
    n = plan.shape[0]
    assert rays.shape[1] == n * tile, (rays.shape, n, tile)
    return pl.pallas_call(
        kernel,
        grid=(n,),
        in_specs=[pl.BlockSpec((1, plan.shape[1]), lambda i: (i, 0)),
                  pl.BlockSpec((RAY_ROWS, tile), lambda i: (0, i)),
                  pl.BlockSpec(geom.shape, lambda i: (0, 0))],
        out_specs=[pl.BlockSpec((tile,), lambda i: (i,))] * len(out_shape),
        out_shape=out_shape,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        interpret=interpret,
        name=kernel.func.__name__.strip("_"),
    )(plan, rays, geom)


@functools.partial(jax.jit, static_argnames=(
    "tile", "window", "chunk", "eps", "num_warps", "interpret"))
def nearest(plan, rays, geom, *, tile: int, window: int, chunk: int,
            eps: float, num_warps: int = 4, interpret: bool = False):
    """plan [n, W] i32, rays [RAY_ROWS, n*tile], geom [GEOM_ROWS, T]
    -> (t [n*tile] f32, idx [n*tile] i32; misses +inf / -1)."""
    Rp = rays.shape[1]
    kern = functools.partial(_nearest_kernel, window=window, chunk=chunk,
                             eps=eps)
    t, idx = _call(kern, plan, rays, geom,
                   [jax.ShapeDtypeStruct((Rp,), jnp.float32),
                    jax.ShapeDtypeStruct((Rp,), jnp.int32)],
                   tile, num_warps, interpret)
    return t, idx


@functools.partial(jax.jit, static_argnames=(
    "tile", "window", "chunk", "eps", "no_max_t", "num_warps", "interpret"))
def anyhit(plan, rays, geom, *, tile: int, window: int, chunk: int,
           eps: float, no_max_t: bool = True, num_warps: int = 4,
           interpret: bool = False):
    """Occlusion: any hit on a triangle of ANOTHER object than the ray's
    self_obj row (simple_raytracer.cpp:321-342).  -> found [n*tile] bool."""
    Rp = rays.shape[1]
    kern = functools.partial(_anyhit_kernel, window=window, chunk=chunk,
                             eps=eps, no_max_t=no_max_t)
    (found,) = _call(kern, plan, rays, geom,
                     [jax.ShapeDtypeStruct((Rp,), jnp.int32)],
                     tile, num_warps, interpret)
    return found != 0


# ---------------------------------------------------------------------------
# Plain jnp twins: the same walk over the same plan, all tiles in lockstep.
# ---------------------------------------------------------------------------

def _reference_setup(plan, rays, geom, tile, window):
    n = plan.shape[0]
    cap = plan.shape[1] - PLAN_AUX
    use_list = plan[:, 3] == 1
    cnt = jnp.where(use_list, plan[:, 2], plan[:, 1])
    r = rays.reshape(RAY_ROWS, n, tile)
    o = tuple(r[k][:, :, None] for k in range(3))
    d = tuple(r[3 + k][:, :, None] for k in range(3))
    lanes = jnp.arange(window, dtype=jnp.int32)

    def window_rows(k):
        e = plan[:, PLAN_AUX + jnp.minimum(k, cap - 1)]
        first = jnp.where(use_list, e & 0xFFFF, plan[:, 0] + k) * window
        g = geom[:, first[:, None] + lanes[None, :]]          # [rows, n, W]
        return first, tuple(g[q][:, None, :] for q in range(GEOM_ROWS)), e
    return n, cnt, use_list, o, d, r[6][:, :, None], window_rows


@functools.partial(jax.jit, static_argnames=("tile", "window", "eps"))
def nearest_reference(plan, rays, geom, *, tile: int, window: int,
                      eps: float):
    """jnp twin of :func:`nearest`."""
    n, cnt, use_list, o, d, _, window_rows = _reference_setup(
        plan, rays, geom, tile, window)
    lane = jnp.arange(window, dtype=jnp.int32)[None, None, :]

    def cond(state):
        k, _, _, done = state
        return jnp.any((k < cnt) & ~done)

    def body(state):
        k, best_t, best_i, done = state
        first, rows, _ = window_rows(k)
        t = _mt(o, d, rows[:9], eps)                          # [n, tile, W]
        tmin = jnp.min(t, axis=2)
        arg = jnp.min(jnp.where(t == tmin[:, :, None], lane, window), axis=2)
        ids = first[:, None] + arg
        live = ((k < cnt) & ~done)[:, None]
        better = live & ((tmin < best_t)
                         | ((tmin == best_t) & (ids < best_i)))
        best_t = jnp.where(better, tmin, best_t)
        best_i = jnp.where(better, ids, best_i)
        _, _, e_next = window_rows(k + 1)
        worst = jnp.max(jax.lax.bitcast_convert_type(best_t, jnp.int32),
                        axis=1)
        done = done | (use_list & (worst < (e_next & jnp.int32(-65536))))
        return k + 1, best_t, best_i, done

    T = rays.shape[1] // n
    init = (jnp.int32(0), jnp.full((n, T), jnp.inf, jnp.float32),
            jnp.full((n, T), _NO_INDEX, jnp.int32), jnp.zeros((n,), bool))
    _, best_t, best_i, _ = jax.lax.while_loop(cond, body, init)
    best_t = best_t.reshape(-1)
    return best_t, jnp.where(best_t < jnp.inf, best_i.reshape(-1), -1)


@functools.partial(jax.jit, static_argnames=("tile", "window", "eps",
                                             "no_max_t"))
def anyhit_reference(plan, rays, geom, *, tile: int, window: int, eps: float,
                     no_max_t: bool = True):
    """jnp twin of :func:`anyhit`."""
    n, cnt, _, o, d, self_obj, window_rows = _reference_setup(
        plan, rays, geom, tile, window)

    def cond(state):
        k, _, done = state
        return jnp.any((k < cnt) & ~done)

    def body(state):
        k, found, done = state
        _, rows, _ = window_rows(k)
        t = _mt(o, d, rows[:9], eps)
        occ = (t < jnp.inf) & (rows[9] != self_obj)
        if not no_max_t:
            occ = occ & (t <= 1.0)
        live = ((k < cnt) & ~done)[:, None]
        found = found | (live & jnp.any(occ, axis=2))
        return k + 1, found, done | jnp.all(found, axis=1)

    init = (jnp.int32(0), jnp.zeros((n, tile), bool), jnp.zeros((n,), bool))
    _, found, _ = jax.lax.while_loop(cond, body, init)
    return found.reshape(-1)
