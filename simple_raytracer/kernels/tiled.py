"""Tiled renderer: per-tile block culling + the window walk.

Each ray TILE (``tile`` consecutive rays of a coherent bundle — a piece of
a square pixel tile for primary rays) culls the scene's triangle BLOCKS
(``block_size`` consecutive triangles in BVH order, accel/bvh.py:
triangle_blocks) with a conservative test, and the visible blocks are
grouped into WINDOWS (``window_blocks`` consecutive blocks).  The plan of a
tile is the front-to-back list of its visible windows, or, when more than
``cull_maxv`` windows are visible, the covering contiguous window range.
The planners here are plain jnp; kernels/walk.py walks the plans (the
nearest-hit walk breaks early once no later window can win).

Plan layout (one int32 row per tile, ``plan_w`` wide): columns 0-7 are
lo_window, range_windows, list_cnt, use_list, 0, 0, 0, 0; the rest are
packed entries ``window_id | bound16 << 16``, bound-ascending, where
bound16 = top 16 bits of the f32 conservative entry t (IEEE ordering: for
non-negative floats, bit-pattern order is value order, and truncation
rounds the bound DOWN, keeping the break conservative).

Misses return t=+inf / idx=-1, matching ops/intersect.py conventions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import KernelConfig, RenderConfig
from ..render import integrator
from ..utils import pad_rays
from . import walk
from .walk import PLAN_AUX

PLAN_W = 256        # default plan row: 248 list entries
T_BUCKETS = 8       # front-to-back ordering buckets per tile
DEFAULT_TILE_PX = 16


def _dot3(a, w):
    """a [..., 3] . w [3], elementwise (a matmul of this shape may run at
    reduced precision on a GPU)."""
    return a[..., 0] * w[0] + a[..., 1] * w[1] + a[..., 2] * w[2]


def cull_blocks(o: jnp.ndarray, d: jnp.ndarray, tile: int,
                block_min: jnp.ndarray, block_max: jnp.ndarray,
                block_obj=None, excl=None, hourglass: bool = False):
    """Conservative per-(ray tile, triangle block) visibility -> block RANGE.

    Interval-arithmetic slab test: each tile is abstracted by the AABBs of its
    ray origins and directions; a block can be skipped only if NO ray with
    o in [omin,omax], d in [dmin,dmax], t >= 0 can touch the block AABB.
    Per axis the reachable-t set is an interval (or everything, when the
    direction interval spans 0 or the offset interval spans 0); the block is
    visible iff the three axis intervals intersect.

    Returns (lo [n_tiles] i32, cnt [n_tiles] i32): the contiguous range
    [lo, lo+cnt) covering every visible block (cnt 0 when none).
    """
    vis_fn = _visibility_hourglass if hourglass else _visibility
    visible, _, n = vis_fn(o, d, tile, block_min, block_max,
                           block_obj, excl)
    NB = visible.shape[1]
    idx = jnp.arange(NB, dtype=jnp.int32)
    first = jnp.min(jnp.where(visible, idx, NB), axis=-1)     # [n]
    last = jnp.max(jnp.where(visible, idx, -1), axis=-1)
    cnt = jnp.maximum(last - first + 1, 0).astype(jnp.int32)
    lo = jnp.where(cnt > 0, first, 0).astype(jnp.int32)
    return lo, cnt


def cull_blocks_lists(o: jnp.ndarray, d: jnp.ndarray, tile: int,
                      block_min: jnp.ndarray, block_max: jnp.ndarray,
                      maxv: int, block: int, window_tris: int,
                      block_obj=None, excl=None, plan_w: int = None,
                      hourglass: bool = False, apex: bool = False,
                      apex_rev: bool = False):
    """Window-list culling with range fallback -> the plan table.

    Conservative visibility is evaluated at fine BLOCK granularity
    (:func:`_visibility`) and reduced to WINDOWS (``window_tris``/``block``
    consecutive blocks): a window is walked iff any member block is
    visible, and its front-to-back bound is the min member entry-t.  Tiles
    whose visible-window count fits ``maxv`` get an EXACT compacted window
    list; heavier tiles fall back to the covering contiguous range.

    ``apex``: the rays share ONE origin (primary rays) — visibility is
    additionally tightened by the projective pixel-space test
    (:func:`_visibility_px`).  ``apex_rev``: the rays all END at one point
    (hard-shadow rays: o + d is the light for every ray) — the same
    projective test from the light, as the union of the two cones through
    it (toward the points, and beyond the light: the reference's shadow
    test has no max-t clipping, so occluders past the light still count —
    simple_raytracer.cpp:321-342).

    Returns the plan [n, plan_w] i32: aux columns (lo_window,
    range_windows, list_cnt, use_list, 0...) then packed entries
    ``window_id | bound16 << 16``, bound-ascending (kernels/walk.py reads
    it).
    """
    if hourglass:
        visible_b, tlo_b, n = _visibility_hourglass(o, d, tile, block_min,
                                                    block_max, block_obj,
                                                    excl)
    else:
        visible_b, tlo_b, n = _visibility(o, d, tile, block_min,
                                          block_max, block_obj, excl)
    if apex:
        visible_b = visible_b & _visibility_px(o, d, tile, block_min,
                                               block_max)[0]
    if apex_rev:
        # REFINEMENT only: the sign-free line test cannot exclude blocks
        # BEHIND the shadow-ray origins (t < 0 on the line through the
        # light — e.g. the occluder mesh itself for points on it), so the
        # interval/hourglass test above keeps the t >= 0 bound and px_rev
        # adds the angular tightening around the light.
        visible_b = visible_b & _visibility_px_rev(
            o, d, tile, block_min, block_max)[0]
    # the [n, NB] mask/bound each feed several reductions below; keep XLA
    # from re-fusing the producing compare chains into every consumer
    visible_b, tlo_b = jax.lax.optimization_barrier((visible_b, tlo_b))
    NB = visible_b.shape[1]
    BPW = window_tris // block          # blocks per window (exact: prepare)
    NW = NB // BPW
    INF = jnp.float32(jnp.inf)
    visible = visible_b.reshape(n, NW, BPW).any(-1)               # [n, NW]
    tlo = jnp.min(jnp.where(visible_b, tlo_b, INF).reshape(n, NW, BPW),
                  axis=-1)
    # plan entries pack the window id into 16 bits
    assert NW <= 65536, (
        f"{NW} windows exceed the 16-bit plan-entry id space; "
        "use range culling (cull_maxv=0) or wider windows")
    idx = jnp.arange(NW, dtype=jnp.int32)
    first = jnp.min(jnp.where(visible, idx, NW), axis=-1)
    last = jnp.max(jnp.where(visible, idx, -1), axis=-1)
    range_cnt = jnp.maximum(last - first + 1, 0).astype(jnp.int32)
    lo = jnp.where(range_cnt > 0, first, 0).astype(jnp.int32)

    pw = plan_w or PLAN_W
    mv_cap = pw - PLAN_AUX
    win_cnt = visible.sum(axis=-1).astype(jnp.int32)
    maxv = min(maxv, mv_cap)
    use_list = (win_cnt <= maxv).astype(jnp.int32)

    # order entries front-to-back: bucket each window by its entry bound
    # (relative to the tile's range), and pack the truncated 16-bit float
    # bound so the walk can stop once every ray's best hit beats the next
    # entry's bound
    tmin = jnp.min(jnp.where(visible, tlo, INF), axis=-1)         # [n]
    tmax = jnp.max(jnp.where(visible, tlo, -INF), axis=-1)
    tmin = jnp.where(jnp.isfinite(tmin), tmin, 0.0)
    qscale = jnp.maximum(tmax - tmin, 1e-20) / T_BUCKETS
    qb = jnp.clip(((tlo - tmin[:, None]) / qscale[:, None]).astype(jnp.int32),
                  0, T_BUCKETS - 1)
    # the packed bound is the BUCKET FLOOR, not the entry's own t: within a
    # bucket entries are in window-index order, so only the floor
    # lower-bounds every later entry (bucket-ascending => floors
    # non-decreasing).  The 16-bit truncation rounds down, keeping it
    # conservative.
    floor_t = jnp.maximum(tmin[:, None] + qb.astype(jnp.float32)
                          * qscale[:, None], 0.0)
    bound16 = jax.lax.shift_right_logical(
        jax.lax.bitcast_convert_type(floor_t, jnp.int32), 16)

    # bucket-ordered compaction via ONE top_k: the entry
    # ``(bound16 << 16) | window_id`` IS a valid sort key — non-negative
    # IEEE floats order as ints, so bound16 is monotone in floor_t (and
    # < 0x8000 for every finite floor_t), and the id low bits make keys
    # unique with id-ascending tie order inside a bucket.  top_k of the
    # negated key returns the front-to-back entry list directly; invisible
    # windows key to +max and land past every real entry.
    key = jnp.where(visible, (bound16 << 16) | idx[None, :],
                    jnp.int32(0x7FFFFFFF))
    k = min(mv_cap, NW)
    negv, _ = jax.lax.top_k(-key, k)           # ascending (bound16, idx)
    entries = -negv
    if k < mv_cap:
        entries = jnp.concatenate(
            [entries, jnp.zeros((n, mv_cap - k), jnp.int32)], axis=-1)
    z = jnp.zeros_like(lo)
    aux = jnp.stack(
        [lo, range_cnt, jnp.minimum(win_cnt, maxv), use_list,
         z, z, z, z], axis=-1)
    return jnp.concatenate([aux, entries], axis=-1)     # [n, plan_w]


def _visibility_hourglass(o, d, tile, block_min, block_max,
                          block_obj=None, excl=None):
    """Apex-aware conservative (tile, block) visibility for SHADOW rays.

    Shadow rays from one tile all pass through (near) the light:
    p(t) = o + t*d = (1-t)*o + t*q with q = o + d, so the true swept
    volume PINCHES at t=1 while the independent-interval test
    (:func:`_visibility`) keeps growing (on a dense scene it kept ~10x
    the windows per shadow tile that a per-ray oracle needs; this test
    keeps ~1.4x).

    Per axis, p(t) is bounded by two LINES between the tile's origin box
    [olo, ohi] and its endpoint box [qlo, qhi] (q per ray = o + d; for
    S folded light samples the box covers all of them).  Two branches
    (the reference's no-max-t quirk keeps rays alive past the light):
      t <= 1:  p in [olo + t(qlo-olo), ohi + t(qhi-ohi)]
      t >= 1:  p in [ohi + t(qlo-ohi), olo + t(qhi-olo)]   (1-t flips)
    Each "range intersects block slab" condition is linear in t, so a
    branch's feasible t-set is one interval; the block is visible iff
    either branch is non-empty.  f32 division rounding is absorbed by a
    relative margin on every threshold (widening only -> conservative).

    Same return contract as _visibility: (visible [n, NB], entry-t lower
    bound [n, NB] (0 when spanning), n).
    """
    o, d, _ = pad_rays(o, d, tile)
    n = o.shape[0] // tile
    ot = o.reshape(n, tile, 3)
    qt = ot + d.reshape(n, tile, 3)
    olo, ohi = ot.min(1), ot.max(1)                      # [n, 3]
    qlo, qhi = qt.min(1), qt.max(1)
    INF = jnp.float32(jnp.inf)
    EPS = jnp.float32(1e-5)

    def branch(lo0, lo1, hi0, hi1, tmin, tmax):
        """Feasible-t interval of {forall axes: lo(t) <= bhi, hi(t) >= blo}
        with lo(t) = lo0 + t*(lo1 - lo0) etc.  Streams per (axis,
        constraint) keeping [n, NB] running bounds."""
        ta = jnp.full((n, 1), tmin, jnp.float32)
        tb = jnp.full((n, 1), tmax, jnp.float32)
        feas = jnp.bool_(True)
        for ax in range(3):
            for c0t, c1t, bnd, ge in (
                    (lo0[:, ax], lo1[:, ax], block_max[None, :, ax], False),
                    (hi0[:, ax], hi1[:, ax], block_min[None, :, ax], True)):
                s = (c1t - c0t)[:, None]                 # [n, 1]
                r = bnd - c0t[:, None]                   # [n, NB]
                if ge:
                    s, r = -s, -r
                # s*t <= r ; widen thresholds against f32 rounding
                thr = r / jnp.where(s == 0.0, 1.0, s)
                mgn = EPS * (jnp.abs(thr) + 1.0)
                tb = jnp.where(s > 0.0, jnp.minimum(tb, thr + mgn), tb)
                ta = jnp.where(s < 0.0, jnp.maximum(ta, thr - mgn), ta)
                zf = (s == 0.0) & (r < -EPS * (jnp.abs(bnd) + 1.0))
                feas = feas & ~zf
        return feas & (tb >= ta), ta

    visA, taA = branch(olo, qlo, ohi, qhi, 0.0, 1.0)
    visB, taB = branch(ohi, qlo, olo, qhi, 1.0, 3.4e38)
    visible = visA | visB
    t_lo = jnp.minimum(jnp.where(visA, taA, INF),
                       jnp.where(visB, taB, INF))
    t_lo = jnp.where(visible, jnp.maximum(t_lo, 0.0), INF)
    # unreachable blocks keep t_lo=inf; cull_blocks_lists masks by
    # `visible` before using t_lo, matching _visibility's contract
    t_lo = jnp.where(jnp.isfinite(t_lo), t_lo, 0.0)
    if block_obj is not None and excl is not None:
        visible = visible & (block_obj[None, :] != excl[:, None])
    return visible, t_lo, n


def _visibility(o, d, tile, block_min, block_max,
                block_obj=None, excl=None):
    """Shared conservative (tile, block) visibility mask [n, NB].

    ``excl`` [n] i32 (with ``block_obj`` [NB] i32, see
    PreparedScene.block_obj) drops blocks whose every triangle belongs to
    the tile's excluded object — the shadow-time self-object cull: the
    reference skips the hit object's OWN triangles entirely
    (simple_raytracer.cpp:331), so when every shadow ray of a tile leaves
    the same object, that object's pure blocks can never occlude the tile
    and need not be fetched/tested at all.  -2 (or any id matching no
    block) disables masking for that tile; impure blocks carry -9.
    """
    o, d, _ = pad_rays(o, d, tile)
    n = o.shape[0] // tile
    ot = o.reshape(n, tile, 3)
    dt = d.reshape(n, tile, 3)
    omin, omax = ot.min(1), ot.max(1)
    dmin, dmax = dt.min(1), dt.max(1)
    INF = jnp.float32(jnp.inf)
    # processed PER AXIS with [n, NB] running intervals: the axis-stacked
    # form would materialize [4, n, NB, 3] f32 intermediates (identical
    # math, 12x the temporaries)
    t_lo = None
    t_hi = None
    for ax in range(3):
        lo_i = block_min[None, :, ax] - omax[:, None, ax]      # [n, NB]
        hi_i = block_max[None, :, ax] - omin[:, None, ax]
        dn = dmin[:, None, ax]
        dx = dmax[:, None, ax]
        c0 = _safe_div(lo_i, dn)
        c1 = _safe_div(lo_i, dx)
        c2 = _safe_div(hi_i, dn)
        c3 = _safe_div(hi_i, dx)
        tmin_ax = jnp.minimum(jnp.minimum(c0, c1), jnp.minimum(c2, c3))
        tmax_ax = jnp.maximum(jnp.maximum(c0, c1), jnp.maximum(c2, c3))
        spans = ((dn <= 0.0) & (dx >= 0.0)) | ((lo_i <= 0.0) & (hi_i >= 0.0))
        tmin_ax = jnp.where(spans, 0.0, jnp.maximum(tmin_ax, 0.0))
        tmax_ax = jnp.where(spans, INF, tmax_ax)
        t_lo = tmin_ax if t_lo is None else jnp.maximum(t_lo, tmin_ax)
        t_hi = tmax_ax if t_hi is None else jnp.minimum(t_hi, tmax_ax)
    # t_lo == +inf means the entry time is unbounded (an axis whose direction
    # interval is {0} with a strictly-positive offset interval produces
    # all-inf slab candidates): the block is genuinely unreachable.  Without
    # this guard inf >= inf would mark it visible and poison the tile's
    # front-to-back quantization (qscale=inf -> floor_t=NaN -> bogus early
    # break in the kernel).
    visible = (t_hi >= t_lo) & (t_hi >= 0.0) & (t_lo < jnp.inf)
    if block_obj is not None and excl is not None:
        visible = visible & (block_obj[None, :] != excl[:, None])
    return visible, jnp.maximum(t_lo, 0.0), n


def _px_frame(d):
    """Orthonormal (s, v, w) with w ~ the bundle's mean direction: the
    projection frame for :func:`_visibility_px`.  Any frame works (the test
    compares projections of the SAME rays and blocks), so robustness beats
    choice: s is built against the coordinate axis least aligned with w."""
    w = d.sum(0)
    nw = jnp.sqrt((w * w).sum())
    w = jnp.where(nw > 1e-20, w / jnp.maximum(nw, 1e-20),
                  jnp.array([0.0, 0.0, 1.0], d.dtype))
    e = (jnp.arange(3) == jnp.argmin(jnp.abs(w))).astype(d.dtype)
    s = jnp.cross(w, e)
    s = s / jnp.sqrt((s * s).sum())
    return s, jnp.cross(w, s), w


def _px_block_corners(block_min, block_max, apex):
    """Block AABB corners relative to the apex [NB, 8, 3] + the empty mask
    (the inverted-box convention marks pad/empty blocks)."""
    bits = ((jnp.arange(8)[:, None] >> jnp.arange(3)[None, :]) & 1) == 1
    corn = jnp.where(bits[None], block_max[:, None], block_min[:, None])
    empty = (block_min > block_max).any(axis=-1)
    return corn - apex, empty


def _visibility_px(o, d, tile, block_min, block_max,
                   block_obj=None, excl=None):
    """Projective (pixel-space) conservative (tile, block) visibility for
    COMMON-APEX ray bundles — primary rays, where every ray of the frame
    leaves one camera origin.  Returns (visible [n, NB], tlo [n, NB], n) —
    the same contract as :func:`_visibility`, whose mask it refines.

    A ray o0 + t*dir intersects a point x iff x - o0 is parallel to dir,
    so in any frame (s, v, w) with dir·w > 0 the ray's projective coords
    (dir·s/dir·w, dir·v/dir·w) must fall inside the block AABB's projected
    rect — the classic rasterizer frustum cull, EXACT per (tile rect, box)
    for boxes fully in front (the per-axis slab interval test treats the
    tile's direction box per axis and keeps ~7x the windows per tile on
    a primary-ray frame).

    The entry bound is projective too: every hit satisfies
    t = ((x-o0)·w)/(dir·w), so t >= min_corners(c·w) / max_tile(dir·w),
    both strictly positive for in-front blocks and in-cone rays.

    Conservative handling: rays with dir·w <= eps (outside the <90 deg
    projection cone) give their tile an unbounded rect and a zero entry
    bound; blocks with SOME corners behind the apex plane get an unbounded
    rect; blocks with ALL corners behind it are invisible to in-cone rays
    (t would be negative) and visible-unbounded to tiles containing
    out-of-cone rays; empty/inverted (pad) blocks are invisible; ``excl``
    culls pure self-object blocks exactly like :func:`_visibility`.
    Block rects are expanded by 1e-4*(1+|u|) against f32 projection
    rounding (<= half a pixel at the reference's focal range, orders
    tighter than the slack this test removes).
    """
    BIG = jnp.float32(3.0e38)
    eps = jnp.float32(1e-12)
    o, d, _ = pad_rays(o, d, tile)
    n = o.shape[0] // tile
    s, v, w = _px_frame(d)

    dw = _dot3(d, w)
    bad_r = dw <= eps
    dws = jnp.maximum(dw, eps)
    ru = _dot3(d, s) / dws
    rv = _dot3(d, v) / dws
    ru_lo = jnp.where(bad_r, -BIG, ru).reshape(n, tile).min(1)
    ru_hi = jnp.where(bad_r, BIG, ru).reshape(n, tile).max(1)
    rv_lo = jnp.where(bad_r, -BIG, rv).reshape(n, tile).min(1)
    rv_hi = jnp.where(bad_r, BIG, rv).reshape(n, tile).max(1)
    tile_bad = bad_r.reshape(n, tile).any(1)
    dw_hi = jnp.where(bad_r, 0.0, dw).reshape(n, tile).max(1)
    apex = o[0]

    c, empty = _px_block_corners(block_min, block_max, apex)
    cw = _dot3(c, w)
    front = (cw > eps).all(axis=1)                       # fully in front
    behind = (cw <= eps).all(axis=1)
    cws = jnp.maximum(cw, eps)
    cu = _dot3(c, s) / cws
    cv = _dot3(c, v) / cws

    def bounds(p):
        lo, hi = p.min(1), p.max(1)
        pad_lo = 1e-4 * (1.0 + jnp.abs(lo))
        pad_hi = 1e-4 * (1.0 + jnp.abs(hi))
        return (jnp.where(front, lo - pad_lo, -BIG),
                jnp.where(front, hi + pad_hi, BIG))

    bu_lo, bu_hi = bounds(cu)
    bv_lo, bv_hi = bounds(cv)
    visible = ((bu_lo[None] <= ru_hi[:, None]) &
               (bu_hi[None] >= ru_lo[:, None]) &
               (bv_lo[None] <= rv_hi[:, None]) &
               (bv_hi[None] >= rv_lo[:, None]))
    visible = visible & ~empty[None, :] & \
        ~(behind[None, :] & ~tile_bad[:, None])
    if block_obj is not None and excl is not None:
        visible = visible & (block_obj[None, :] != excl[:, None])
    # projective entry bound (0 whenever either side is unbounded: a tile
    # with ANY out-of-cone ray cannot bound t through dw_hi)
    cw_lo = jnp.where(front, cw.min(axis=1), 0.0)
    tlo = jnp.maximum(cw_lo[None, :], 0.0) / \
        jnp.maximum(dw_hi[:, None], eps)
    tlo = jnp.where(tile_bad[:, None], 0.0, tlo)
    return visible, tlo, n


def _visibility_px_rev(o, d, tile, block_min, block_max,
                       block_obj=None, excl=None):
    """Projective LINE-membership visibility for hard-shadow tiles: every
    ray passes through ONE shared light L = o[i] + d[i].  Returns
    (visible [n, NB], tlo [n, NB], n) — same contract as
    :func:`_visibility`, which it REPLACES for shared-light shadow tiles
    (tlo is all-zero: the any-hit walk has no front-to-back break).

    Under the reference's no-max-t rule (simple_raytracer.cpp:321-342)
    occluders anywhere along the line through the point and the light
    count, so the test is on LINES through the apex L.  A line with
    direction delta has sign-free projective coords u = delta.s/delta.w
    (flipping delta flips both factors), and a block whose corners are all
    strictly on ONE side of the apex's w-plane projects to a rect in the
    same coords — so one rect-overlap test covers the point-side cone,
    the beyond-the-light cone, and the behind-the-point extension at
    once.  Blocks straddling the w-plane (they contain directions where
    the projection degenerates) and rays with |d.w| <= eps are
    conservatively visible; empty (pad) blocks and ``excl``-pure blocks
    are culled exactly like :func:`_visibility`.
    """
    BIG = jnp.float32(3.0e38)
    eps = jnp.float32(1e-12)
    o, d, _ = pad_rays(o, d, tile)
    n = o.shape[0] // tile
    s, v, w = _px_frame(-d)              # frame toward the scene
    apex = o[0] + d[0]                   # the shared light (contract)

    dw = _dot3(d, w)
    bad_r = jnp.abs(dw) <= eps
    dws = jnp.where(bad_r, eps, dw)
    ru = _dot3(d, s) / dws
    rv = _dot3(d, v) / dws
    ru_lo = jnp.where(bad_r, -BIG, ru).reshape(n, tile).min(1)
    ru_hi = jnp.where(bad_r, BIG, ru).reshape(n, tile).max(1)
    rv_lo = jnp.where(bad_r, -BIG, rv).reshape(n, tile).min(1)
    rv_hi = jnp.where(bad_r, BIG, rv).reshape(n, tile).max(1)

    c, empty = _px_block_corners(block_min, block_max, apex)
    cw = _dot3(c, w)
    ok = (cw > eps).all(axis=1) | (cw < -eps).all(axis=1)
    cws = jnp.where(jnp.abs(cw) > eps, cw, eps)
    cu = _dot3(c, s) / cws
    cv = _dot3(c, v) / cws

    def bounds(p):
        lo, hi = p.min(1), p.max(1)
        pad_lo = 1e-4 * (1.0 + jnp.abs(lo))
        pad_hi = 1e-4 * (1.0 + jnp.abs(hi))
        return (jnp.where(ok, lo - pad_lo, -BIG),
                jnp.where(ok, hi + pad_hi, BIG))

    bu_lo, bu_hi = bounds(cu)
    bv_lo, bv_hi = bounds(cv)
    visible = ((bu_lo[None] <= ru_hi[:, None]) &
               (bu_hi[None] >= ru_lo[:, None]) &
               (bv_lo[None] <= rv_hi[:, None]) &
               (bv_hi[None] >= rv_lo[:, None]))
    visible = visible & ~empty[None, :]
    if block_obj is not None and excl is not None:
        visible = visible & (block_obj[None, :] != excl[:, None])
    return visible, jnp.zeros(visible.shape, jnp.float32), n


def _safe_div(a, b):
    """Interval endpoint division: a/0 -> sign(a)*inf, 0/0 -> 0.  (Any NaN
    that could leak from these corners is masked by the ``spans`` branch in
    cull_blocks, but keep the endpoints finite-signed anyway.)"""
    return jnp.where(b == 0.0,
                     jnp.where(a == 0.0, 0.0, jnp.sign(a) * jnp.inf),
                     a / jnp.where(b == 0.0, 1.0, b))


def cull(prep, origin, direction, tile: int, maxv: int, excl=None,
         wb: int = None, hourglass: bool = False, apex: bool = False,
         apex_rev: bool = False):
    """Plan [n_tiles, plan_w] for the walks over windows of ``wb`` blocks
    (default KernelConfig.window_blocks).  maxv > 0: exact window lists
    with range fallback; maxv == 0 (or scenes past the 16-bit window-id
    space): pure window ranges.  ``excl`` [n] i32: per-tile self-object id
    whose pure blocks are culled (shadow passes; see _visibility)."""
    wb = wb or KernelConfig().window_blocks
    bobj = getattr(prep, "block_obj", None) if excl is not None else None
    NB = prep.block_min.shape[0]
    assert NB % wb == 0, (NB, wb)
    pw = -(-(PLAN_AUX + max(maxv, 0)) // 128) * 128
    if maxv > 0 and NB // wb <= 65536:
        return cull_blocks_lists(
            origin, direction, tile, prep.block_min, prep.block_max,
            maxv, prep.block_size, wb * prep.block_size, bobj, excl,
            plan_w=pw, hourglass=hourglass, apex=apex, apex_rev=apex_rev)
    lo, cnt = cull_blocks(origin, direction, tile, prep.block_min,
                          prep.block_max, bobj, excl, hourglass=hourglass)
    # convert the covering block range to aligned window units
    ulo = lo // wb
    ucnt = jnp.where(cnt > 0, -(-(lo + cnt) // wb) - ulo, 0).astype(jnp.int32)
    z = jnp.zeros_like(lo)
    aux = jnp.stack([ulo, ucnt, z, z, z, z, z, z], axis=-1)
    return jnp.concatenate(
        [aux, jnp.zeros((lo.shape[0], pw - PLAN_AUX), jnp.int32)], axis=-1)


def _walk_args(prep, tile: int, eps: float, kernel: KernelConfig) -> dict:
    window = kernel.window_blocks * prep.block_size
    return dict(tile=tile, window=window, chunk=min(kernel.chunk, window),
                eps=eps, num_warps=kernel.num_warps,
                interpret=kernel.interpret)


def hits(prep, origin, direction, tile: int, eps: float, maxv: int = 248,
         apex: bool = False, kernel: KernelConfig = KernelConfig()):
    """Nearest hit of flat rays [R, 3] -> (t [R], idx [R]) through the
    culled window walk.  ``apex``: the rays share one origin — enables
    the projective pixel-space cull (_visibility_px); UNSOUND otherwise."""
    plan = cull(prep, origin, direction, tile, maxv,
                wb=kernel.window_blocks, apex=apex)
    rays, R = walk.pack_rays(origin, direction, tile)
    t, idx = walk.nearest(plan, rays, prep.geom,
                          **_walk_args(prep, tile, eps, kernel))
    return t[:R], idx[:R]


def _repair_misses(point, so, hit, tile):
    """Replace miss rays' origins (and self-object ids) with a hit of the
    SAME tile, so a miss ray's pinned origin does not blow up its tile's
    cull bounds; their occlusion results are discarded by the shader.
    Returns (point, so, any_hit [n_tiles])."""
    R0 = point.shape[0]
    padn = (-R0) % tile
    if padn:
        point = jnp.concatenate([point, jnp.zeros((padn, 3), point.dtype)])
        hit = jnp.concatenate([hit, jnp.zeros((padn,), hit.dtype)])
        so = jnp.concatenate([so, jnp.broadcast_to(so[-1:], (padn,))])
    nt = point.shape[0] // tile
    p3 = point.reshape(nt, tile, 3)
    h2 = hit.reshape(nt, tile)
    s2 = so.reshape(nt, tile)
    first = jnp.argmax(h2, axis=1)
    fill = jnp.take_along_axis(
        p3, first[:, None, None].repeat(3, axis=2), axis=1)
    p3 = jnp.where(h2[..., None], p3, fill)
    s2 = jnp.where(h2, s2, jnp.take_along_axis(s2, first[:, None], axis=1))
    return p3.reshape(-1, 3)[:R0], s2.reshape(-1)[:R0], h2.any(axis=1)


def _self_excl(so, tile):
    """Per-tile self object whose pure blocks the shadow cull may drop
    (tiles whose rays all leave one object), else -2 (no match)."""
    n = -(-so.shape[0] // tile)
    pad = n * tile - so.shape[0]
    if pad:
        so = jnp.concatenate([so, jnp.broadcast_to(so[-1:], (pad,))])
    s2 = so.reshape(n, tile)
    pure = jnp.all(s2 == s2[:, :1], axis=1)
    return jnp.where(pure, s2[:, 0].astype(jnp.int32), -2)


def tiled_shadow_fn(prep, tile: int, eps: float, maxv: int = 248,
                    no_max_t: bool = True, num_samples: int = 1,
                    kernel: KernelConfig = KernelConfig(),
                    shared_light: bool = True):
    """Occlusion backend for the integrator's shadow contract
    (render/integrator.py: shadow_fn(point, light, self_obj, hit=None)).

    S == 1: every light row is ONE shared position (the integrator
    broadcasts the sample), so the plan adds the projective light-apex
    cull (cull_blocks_lists apex_rev); callers whose rays end at several
    lights pass ``shared_light=False``.  S > 1 (soft shadows): the
    integrator sends S·R rays whose ORIGIN rows repeat per sample; the
    folded path plans each point tile once for all S samples (the jitter
    is +3 units cumulative, simple_raytracer.cpp:362-383, so the direction
    union stays tight) and walks the samples as rows of one kernel tile.
    """
    wargs = _walk_args(prep, tile, eps, kernel)
    wb = kernel.window_blocks

    def shadow(point, light, self_obj, hit=None):
        S = num_samples
        if S > 1 and point.shape[0] % S == 0:
            return _shadow_folded(prep, wargs, wb, maxv, no_max_t, S,
                                  point, light, self_obj, hit)
        so = self_obj.astype(jnp.float32)
        any_hit = None
        if hit is not None:
            point, so, any_hit = _repair_misses(point, so, hit, tile)
        d = light - point
        plan = cull(prep, point, d, tile, maxv, _self_excl(so, tile), wb=wb,
                    apex_rev=S == 1 and shared_light)
        if any_hit is not None:
            plan = jnp.where(any_hit[:, None], plan, 0)   # skip hitless tiles
        rays, R = walk.pack_rays(point, d, tile, so)
        found = walk.anyhit(plan, rays, prep.geom, no_max_t=no_max_t,
                            **wargs)
        return found[:R]

    return shadow


def _fold_shape(tile: int, S: int):
    """(points per tile, rows = S * points, kernel tile): a point tile of
    the folded S-sample shadow pass fills one walk tile, padded up to a
    power of two."""
    ts = max(1, tile // S)
    rows = S * ts
    return ts, rows, max(tile, 1 << (rows - 1).bit_length())


def _shadow_folded(prep, wargs, wb, maxv, no_max_t, S, point, light,
                   self_obj, hit):
    """S-sample occlusion with one plan per point tile (see
    tiled_shadow_fn).  Rays arrive sample-major ([S*R]; origin rows repeat
    per sample); a point tile of ``ts`` points x S samples is one kernel
    tile (padded up to a power of two by repeating its last row)."""
    R = point.shape[0] // S
    ts, rows, ktile = _fold_shape(wargs["tile"], S)
    p0 = point[:R]
    self0 = self_obj[:R].astype(jnp.float32)
    lights = light.reshape(S, R, 3)
    any_hit = None
    if hit is not None:
        p0, self0, any_hit = _repair_misses(p0, self0, hit[:R], ts)
    padn = (-R) % ts
    if padn:
        p0 = jnp.concatenate([p0, jnp.broadcast_to(p0[-1:], (padn, 3))])
        self0 = jnp.concatenate(
            [self0, jnp.broadcast_to(self0[-1:], (padn,))])
        lights = jnp.concatenate(
            [lights, jnp.broadcast_to(lights[:, -1:], (S, padn, 3))], 1)
    nt = p0.shape[0] // ts
    # [nt, S, ts] rows: sample-major within each point tile
    o_g = jnp.broadcast_to(p0.reshape(nt, 1, ts, 3), (nt, S, ts, 3))
    d_g = lights.reshape(S, nt, ts, 3).transpose(1, 0, 2, 3) - o_g
    s_g = jnp.broadcast_to(self0.reshape(nt, 1, ts), (nt, S, ts))
    o_f, d_f = o_g.reshape(nt, rows, 3), d_g.reshape(nt, rows, 3)
    s_f = s_g.reshape(nt, rows)
    if ktile > rows:
        def pad(a):
            return jnp.concatenate(
                [a, jnp.broadcast_to(a[:, -1:], (nt, ktile - rows)
                                     + a.shape[2:])], axis=1)
        o_f, d_f, s_f = pad(o_f), pad(d_f), pad(s_f)
    o_f, d_f, s_f = o_f.reshape(-1, 3), d_f.reshape(-1, 3), s_f.reshape(-1)
    plan = cull(prep, o_f, d_f, ktile, maxv, _self_excl(self0, ts), wb=wb,
                hourglass=True)
    if any_hit is not None:
        plan = jnp.where(any_hit[:, None], plan, 0)
    rays, _ = walk.pack_rays(o_f, d_f, ktile, s_f)
    found = walk.anyhit(plan, rays, prep.geom, no_max_t=no_max_t,
                        **dict(wargs, tile=ktile))
    found = found.reshape(nt, ktile)[:, :rows].reshape(nt, S, ts)
    return found.transpose(1, 0, 2).reshape(S, -1)[:, :R].reshape(-1)


def effective_tile_px(cfg: RenderConfig, num_tris: int = 0) -> int:
    """Pixel tile edge of the tiled path's ray order (config.tile_px;
    0 = 16: a 256-ray square tile, two 128-ray walk tiles)."""
    return cfg.tile_px or DEFAULT_TILE_PX


def _hit_tile(cfg: RenderConfig, tile: int) -> int:
    """Walk tile for a pixel tile of ``tile`` rays: kernel.ray_tile
    consecutive rays (a contiguous piece of the tile-major stream, so it
    stays spatially coherent), or the whole pixel tile if smaller."""
    ht = min(cfg.kernel.ray_tile, tile)
    assert tile % ht == 0 and ht & (ht - 1) == 0, (tile, ht)
    return ht


def render_flat_tiled(prep, cfg: RenderConfig, origin, direction,
                      light_pos):
    """Tiled-mode renderer over flat PRIMARY rays (one shared origin: the
    projective apex cull applies) -> (radiance [R,3], hit [R])."""
    tile = _hit_tile(cfg, effective_tile_px(cfg) ** 2)
    t, tri_idx = hits(prep, origin, direction, tile, cfg.mt_eps,
                      cfg.cull_maxv, apex=True, kernel=cfg.kernel)
    shadow_fn = None
    if cfg.light.enable_shadows:
        shadow_fn = tiled_shadow_fn(prep, tile, cfg.mt_eps, cfg.cull_maxv,
                                    cfg.light.shadow_no_max_t,
                                    cfg.light.num_samples, kernel=cfg.kernel)
    radiance = integrator.shade(prep.scene, cfg, origin, direction, t,
                                tri_idx, light_pos, shadow_fn)
    return radiance, jnp.isfinite(t)
