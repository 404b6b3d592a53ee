"""One streamline or pathline step as torch ops: the stage evaluation
(containment, Wachspress weights, ztop clamp, layer search, vertical lerp)
and the RK4 or Euler step built from it.  These are the plain versions of
the fused step kernels (kernels/stage_kernel.py), and sit below both that
module and the step loop in advect.py.

Mirror of the stage functions of mops_tpu.advect; reference semantics from
src/CPU/TBB/Kernel/MPASOVisualizerKernels.cpp:668-1496.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geo
from .config import EPS_LAYER, EPS_ZERO, ZTOP_CLAMP
from .interp import wachspress_weights


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def _where0(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# horizontal geometry
# ---------------------------------------------------------------------------

def _in_mesh(pos: torch.Tensor, vpos: torch.Tensor, nv: torch.Tensor,
             lane_valid: torch.Tensor) -> torch.Tensor:
    """Spherical point-in-polygon (reference SYCLKernel::IsInMesh,
    src/GPU/SYCL/Kernel/SYCLKernel.cpp:41-76): inside iff
    cross(A_k, B_k) . p >= 0 for every edge; non-finite p -> outside.
    Evaluated as cross(A_k - p, B_k - p) . p, the same determinant without
    the float32 cancellation of cross(A_k, B_k) (see the kernels'
    ``geometry``)."""
    K = vpos.shape[1]
    lane = torch.arange(K, device=pos.device)[None, :]
    nxt = torch.where(lane == nv[:, None].long() - 1, 0, (lane + 1) % K)
    b = vpos.gather(1, nxt[..., None].expand(vpos.shape))
    p = pos[:, None, :]
    direction = torch.sum(torch.linalg.cross(vpos - p, b - p, dim=-1) * p,
                          dim=-1)
    inside = torch.all(~lane_valid | (direction >= 0.0), dim=1)
    finite = torch.all(torch.isfinite(pos), dim=-1)
    return finite & inside


def _advect_on_sphere(pos: torch.Tensor, vel: torch.Tensor, dt):
    """RK mid-stage move (TBB advect_on_sphere, kernel :729-738): Rodrigues
    rotation by theta = |v| dt / |p|, identity if |p| or |v| < 1e-12."""
    rr = _norm(pos)
    speed = _norm(vel)
    degenerate = (rr < EPS_ZERO) | (speed < EPS_ZERO)
    axis = torch.linalg.cross(pos, vel, dim=-1)
    theta = speed * dt / torch.where(rr == 0.0, torch.ones_like(rr), rr)
    unit_x = torch.tensor([1.0, 0.0, 0.0], dtype=pos.dtype, device=pos.device)
    safe_axis = torch.where(degenerate[..., None], unit_x, axis)
    rotated = geo.rotate_around_axis(pos, safe_axis, theta)
    return torch.where(degenerate[..., None], pos, rotated)


def _weighted_vertex_value(table: torch.Tensor, vids: torch.Tensor,
                           layer: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """sum_k w_k * table[vid_k, layer] for (nV, L[, 3]) tables
    (reference SYCLKernel::CalcVelocity / CalcAttribute)."""
    gathered = table[vids.long(), layer.long()[:, None]]   # (N, K[, 3])
    if gathered.ndim == 3:
        return torch.einsum("nk,nkd->nd", weights, gathered)
    return torch.einsum("nk,nk->n", weights, gathered)


# ---------------------------------------------------------------------------
# vertical column machinery
# ---------------------------------------------------------------------------

def _clamp_profile(z: torch.Tensor, exact: bool) -> torch.Tensor:
    """Monotonic ztop clamp z[k] = (z[k] > z'[k-1]) ? z'[k-1]-1e-9 : z[k]
    (reference kernel :861-867).  ``exact=False`` uses a parallel cummin form
    that differs from the sequential recurrence only by < 1e-9 m."""
    if exact:
        cols = [z[:, 0]]
        for k in range(1, z.shape[1]):
            prev = cols[-1]
            cols.append(torch.where(z[:, k] > prev, prev - ZTOP_CLAMP, z[:, k]))
        return torch.stack(cols, dim=1)
    idx = torch.arange(z.shape[1], dtype=z.dtype, device=z.device) * ZTOP_CLAMP
    return torch.cummin(z + idx[None, :], dim=1).values - idx[None, :]


def _layer_search_binary(z: torch.Tensor, depth: torch.Tensor,
                         z_surf=None, z_bot=None) -> torch.Tensor:
    """Streamline layer resolution (reference kernel :903-944): above surface
    -> 1, below bottom -> L-1, else the exact binary search with the fixed
    trip count ceil(log2(max(2, L))) + 2; not found -> 1, clipped to
    [1, L-1].  The surface and bottom are z's first and last entries unless
    given (the layer window passes the unclamped column ends)."""
    L = z.shape[1]
    above = depth > (z[:, 0] if z_surf is None else z_surf) + EPS_LAYER
    below = depth < (z[:, -1] if z_bot is None else z_bot) - EPS_LAYER
    lo = torch.ones(depth.shape, dtype=torch.long, device=z.device)
    hi = torch.full_like(lo, L - 1)
    ans = torch.ones_like(lo)
    found = torch.zeros(depth.shape, dtype=torch.bool, device=z.device)

    def pick(idx):
        # inactive lanes may hold any index; their values are never used
        return z.gather(1, torch.clamp(idx, 0, L - 1)[:, None])[:, 0]

    for _ in range(int(np.ceil(np.log2(max(2, L)))) + 2):
        active = (~found) & (lo <= hi)
        mid = (lo + hi) >> 1
        top_i = pick(mid - 1)
        bot_i = pick(mid)
        hit = (depth <= top_i + EPS_LAYER) & (depth >= bot_i - EPS_LAYER)
        ans = torch.where(active & hit, mid, ans)
        found = found | (active & hit)
        go_up = depth > top_i + EPS_LAYER
        hi = torch.where(active & ~hit & go_up, mid - 1, hi)
        lo = torch.where(active & ~hit & ~go_up, mid + 1, lo)
    ans = torch.clamp(ans, 1, L - 1)
    return torch.where(above, 1, torch.where(below, L - 1, ans))


def _layer_search_linear(z: torch.Tensor, depth: torch.Tensor):
    """Pathline layer resolution (reference TBB kernel :1182-1222): above
    surface -> 1 (the reference's layer 0 reads ztop[-1], so it is clamped
    to 1), below bottom -> L-1, else the first k in [1, L-1] whose interval
    holds the depth.  Returns (layer, ok) with ok = above | below | found."""
    L = z.shape[1]
    above = depth > z[:, 0] + EPS_LAYER
    below = depth < z[:, -1] - EPS_LAYER
    cond = (depth[:, None] <= z[:, :-1] + EPS_LAYER) & \
           (depth[:, None] >= z[:, 1:] - EPS_LAYER)          # k = 1..L-1
    found = torch.any(cond, dim=1)
    first = torch.argmax(cond.to(torch.uint8), dim=1) + 1   # first True
    layer = torch.where(above, 1, torch.where(below, L - 1, first))
    return layer, above | below | found


def _vertical_lerp_t(z: torch.Tensor, layer: torch.Tensor,
                     depth: torch.Tensor):
    """t = (clamp(depth) - z_dn) / (z_up - z_dn); fail if |denom| < 1e-12
    (reference kernel :958-985)."""
    z_dn = z.gather(1, layer[:, None])[:, 0]
    z_up = z.gather(1, (layer - 1)[:, None])[:, 0]
    x = torch.minimum(torch.maximum(depth, z_dn), z_up)
    denom = z_up - z_dn
    ok = torch.abs(denom) >= EPS_ZERO
    t = (x - z_dn) / torch.where(ok, denom, torch.ones_like(denom))
    return t, ok


def _pick_two_layers(cols: torch.Tensor, w: torch.Tensor,
                     layer_up: torch.Tensor, layer_dn: torch.Tensor):
    """(up, dn) with up = sum_k w_k * cols[n, k, layer_up[n]] for (N, K, L[, 3])
    columns: a per-particle index on the layer axis."""
    def take(layer):
        idx = layer[:, None, None].expand(cols.shape[0], cols.shape[1], 1)
        if cols.ndim == 4:
            idx = idx[..., None].expand(-1, -1, -1, cols.shape[3])
        return cols.gather(2, idx).squeeze(2)               # (N, K[, 3])
    if cols.ndim == 4:
        return (torch.einsum("nk,nkd->nd", w, take(layer_up)),
                torch.einsum("nk,nkd->nd", w, take(layer_dn)))
    return (torch.einsum("nk,nk->n", w, take(layer_up)),
            torch.einsum("nk,nk->n", w, take(layer_dn)))


# ---------------------------------------------------------------------------
# stage evaluation and the step
# ---------------------------------------------------------------------------

def _eval_stage_streamline(ztop_cols, vel_cols, wvel_cols,
                           pos, depth_neg, nv, lane_valid, vpos,
                           exact_clamp: bool):
    """One CalcVelocityAt evaluation (streamline).  Returns (hvel, wvel, ok);
    failed lanes carry zeros, mirroring the reference RET0.

    The ``*_cols`` are the per-cell vertex-column gathers ((N,K,L) ztop,
    (N,K,L,3) velocity, (N,K,L+1) vertical velocity), shared by the RK
    stages since the cell is frozen across them."""
    in_mesh = _in_mesh(pos, vpos, nv, lane_valid)
    w = wachspress_weights(pos, vpos, nv)

    z = torch.einsum("nk,nkl->nl", w, ztop_cols)
    z = _clamp_profile(z, exact_clamp)
    layer = _layer_search_binary(z, depth_neg)
    t, ok_denom = _vertical_lerp_t(z, layer, depth_neg)

    v_up, v_dn = _pick_two_layers(vel_cols, w, layer - 1, layer)
    ok_mag = (_norm(v_dn) >= EPS_ZERO) & (_norm(v_up) >= EPS_ZERO)
    hvel = t[:, None] * v_up + (1.0 - t[:, None]) * v_dn
    ok_final = _norm(hvel) >= EPS_ZERO

    lp1 = wvel_cols.shape[2]
    dn_if = torch.clamp(layer, max=lp1 - 1)
    up_if = torch.clamp(torch.clamp(layer - 1, min=0), max=lp1 - 1)
    w_up, w_dn = _pick_two_layers(wvel_cols, w, up_if, dn_if)
    wvel = t * w_up + (1.0 - t) * w_dn

    ok = in_mesh & ok_denom & ok_mag & ok_final
    return _where0(ok[:, None], hvel), _where0(ok, wvel), ok


def _eval_stage_pathline(cols_f, cols_b, pos, depth_neg, alpha, nv,
                         lane_valid, vpos, exact_clamp: bool, n_attrs: int):
    """One CalcVelocityAt(pos, cell, alpha) evaluation (pathline): one
    Wachspress weight set, then an independent clamp, linear layer search
    and vertical lerp in each snapshot, blended as a*back + (1-a)*front
    (reference TBB kernel :1124-1327).  No per-snapshot |v| guard.  Returns
    (hvel, wvel, attr (N, 3), ok); failed lanes carry zeros.

    ``cols_f``/``cols_b`` are (ztop (N,K,L), vel (N,K,L,3), wvel (N,K,L+1),
    attrs (N,K,L,A) or None) per snapshot; ``n_attrs`` <= 2 of the
    attributes are interpolated, into slots 0..n_attrs-1 of attr."""
    in_mesh = _in_mesh(pos, vpos, nv, lane_valid)
    w = wachspress_weights(pos, vpos, nv)

    def column(cols):
        ztop, vel, wvel_c, attrs = cols
        z = _clamp_profile(torch.einsum("nk,nkl->nl", w, ztop), exact_clamp)
        layer, ok_layer = _layer_search_linear(z, depth_neg)
        t, ok_denom = _vertical_lerp_t(z, layer, depth_neg)
        v_up, v_dn = _pick_two_layers(vel, w, layer - 1, layer)
        hvel = t[:, None] * v_up + (1.0 - t[:, None]) * v_dn
        lp1 = wvel_c.shape[2]
        dn_if = torch.clamp(layer, max=lp1 - 1)
        up_if = torch.clamp(torch.clamp(layer - 1, min=0), max=lp1 - 1)
        w_up, w_dn = _pick_two_layers(wvel_c, w, up_if, dn_if)
        wvel = t * w_up + (1.0 - t) * w_dn
        att = []
        for ai in range(n_attrs):
            a_up, a_dn = _pick_two_layers(attrs[..., ai], w, layer - 1, layer)
            att.append(t * a_up + (1.0 - t) * a_dn)
        return hvel, wvel, att, ok_layer & ok_denom

    hv_f, wv_f, at_f, ok_f = column(cols_f)
    hv_b, wv_b, at_b, ok_b = column(cols_b)
    a = alpha
    hvel = a * hv_b + (1.0 - a) * hv_f
    wvel = a * wv_b + (1.0 - a) * wv_f
    attr = torch.zeros_like(pos)
    for ai in range(n_attrs):
        attr[:, ai] = a * at_b[ai] + (1.0 - a) * at_f[ai]
    ok = in_mesh & ok_f & ok_b
    return (_where0(ok[:, None], hvel), _where0(ok, wvel),
            _where0(ok[:, None], attr), ok)


def _rk4_endpoint(pos, hvel, r, dt):
    """pos + hvel*dt renormalised to the pre-step radius r (identity when
    the trial point is at the origin)."""
    x_trial = pos + hvel * dt
    x_len = _norm(x_trial)
    return torch.where(
        (x_len > EPS_ZERO)[:, None],
        x_trial / torch.where(x_len == 0.0, torch.ones_like(x_len),
                              x_len)[:, None] * r[:, None],
        pos)


def pathline_step(cols_f, cols_b, pos, depth_neg, nv, vpos, dt: float,
                  alphas, euler: bool, n_attrs: int = 0,
                  exact_clamp: bool = True):
    """One whole pathline step (RK4 or Euler) of each particle in its frozen
    cell against two snapshots.  ``alphas`` = (a1, a2, a4), the time weights
    of stage 1, stages 2-3 and stage 4 (0-d tensors or floats).  Returns
    (new_pos, hvel, wvel, ok, attr (N, 3))."""
    lane_valid = torch.arange(vpos.shape[1], device=pos.device)[None, :] \
        < nv[:, None]
    a1, a2, a4 = alphas

    def eval_at(p, a):
        return _eval_stage_pathline(cols_f, cols_b, p, depth_neg, a, nv,
                                    lane_valid, vpos, exact_clamp, n_attrs)

    r = _norm(pos)
    if euler:
        hvel, wvel, attr, ok = eval_at(pos, a1)
        axis = geo.rotation_axis(pos, hvel)
        theta = _norm(hvel) * dt / torch.clamp(r, min=EPS_ZERO)
        return (geo.rotate_around_axis(pos, axis, theta), hvel, wvel, ok,
                attr)

    k1, w1, at1, ok1 = eval_at(pos, a1)
    k2, w2, at2, ok2 = eval_at(_advect_on_sphere(pos, k1, dt * 0.5), a2)
    k3, w3, at3, ok3 = eval_at(_advect_on_sphere(pos, k2, dt * 0.5), a2)
    k4, w4, at4, ok4 = eval_at(_advect_on_sphere(pos, k3, dt), a4)
    hvel = (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
    wvel = (w1 + 2.0 * w2 + 2.0 * w3 + w4) / 6.0
    attr = (at1 + 2.0 * at2 + 2.0 * at3 + at4) / 6.0
    return (_rk4_endpoint(pos, hvel, r, dt), hvel, wvel,
            ok1 & ok2 & ok3 & ok4, attr)


def streamline_step(ztop_cols, vel_cols, wvel_cols, pos, depth_neg, nv,
                    vpos, dt: float, euler: bool, exact_clamp: bool = True):
    """One whole streamline step (RK4 or Euler) of each particle in its
    frozen cell, from the cell's (N, K, ...) vertex columns and positions
    vpos (N, K, 3).  Returns (new_pos, hvel, wvel, ok)."""
    lane_valid = torch.arange(vpos.shape[1], device=pos.device)[None, :] \
        < nv[:, None]

    def eval_at(p):
        return _eval_stage_streamline(ztop_cols, vel_cols, wvel_cols, p,
                                      depth_neg, nv, lane_valid, vpos,
                                      exact_clamp)

    r = _norm(pos)
    if euler:
        hvel, wvel, ok = eval_at(pos)
        axis = geo.rotation_axis(pos, hvel)
        theta = _norm(hvel) * dt / torch.clamp(r, min=EPS_ZERO)
        return geo.rotate_around_axis(pos, axis, theta), hvel, wvel, ok

    k1, w1, ok1 = eval_at(pos)
    k2, w2, ok2 = eval_at(_advect_on_sphere(pos, k1, dt * 0.5))
    k3, w3, ok3 = eval_at(_advect_on_sphere(pos, k2, dt * 0.5))
    k4, w4, ok4 = eval_at(_advect_on_sphere(pos, k3, dt))
    ok = ok1 & ok2 & ok3 & ok4
    hvel = (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
    wvel = (w1 + 2.0 * w2 + 2.0 * w3 + w4) / 6.0
    return _rk4_endpoint(pos, hvel, r, dt), hvel, wvel, ok


def start_layer(ztop_cols, pos, depth_neg, nv, vpos, pathline: bool):
    """The layer holding each particle's depth at its position: the binary
    (streamline) or first-hit linear (pathline) search on the clamped
    profile.  The layer window is placed around it."""
    w = wachspress_weights(pos, vpos, nv)
    z = _clamp_profile(torch.einsum("nk,nkl->nl", w, ztop_cols), True)
    return _layer_search_linear(z, depth_neg)[0] if pathline \
        else _layer_search_binary(z, depth_neg)


# ---------------------------------------------------------------------------
# the layer-window step (mirror of mops_tpu/pallas/window_kernel.py::_wkernel)
# ---------------------------------------------------------------------------
#
# Each stage reads only W layers [s, s+W) of each column: the profile is
# summed over the window and clamped from the window's top, layers outside it
# read as +BIG above and -BIG below, and the surface and bottom tests use the
# unclamped column ends (of the front snapshot, for both snapshots of a
# pathline).  A depth within EPS_LAYER of a window edge that is not a column
# end could belong to a layer outside: that lane is a miss.  Off the miss
# lanes every comparison resolves as in the full column, so the results are
# the full step's.

BIG = 1e30


def window_margin(n_window: int) -> int:
    """Layers kept above the carried layer: the window starts W/2 - 1 above."""
    return max(1, n_window // 2 - 1)


def window_starts(layer: torch.Tensor, n_layers: int,
                  n_window: int) -> torch.Tensor:
    """Per-particle window start s = clip(layer - margin, 0, L - W)."""
    return torch.clamp(layer - window_margin(n_window), 0,
                       n_layers - n_window).to(torch.int32)


def window_cols(cols, s: torch.Tensor, n_window: int):
    """Slice layers s..s+W-1 out of (N, K, L[, C]) columns (None stays)."""
    if cols is None:
        return None
    n, K = cols.shape[:2]
    idx = (s.long()[:, None] + torch.arange(n_window, device=s.device))
    idx = idx[:, None, :].expand(n, K, n_window)
    if cols.ndim == 4:
        idx = idx[..., None].expand(-1, -1, -1, cols.shape[3])
    return cols.gather(2, idx)


def _window_sentinels(z: torch.Tensor, s: torch.Tensor, n_layers: int):
    """(N, L) profile: the window's z at layers s..s+W-1, +BIG above the
    window and -BIG below it (the TPU kernel's zw_at)."""
    n, W = z.shape
    lg = torch.arange(n_layers, device=z.device)[None, :]
    full = torch.where(lg < s.long()[:, None], BIG, -BIG).to(z.dtype)
    idx = s.long()[:, None] + torch.arange(W, device=z.device)[None, :]
    return full.scatter(1, idx, z)


def _window_miss(z, s, depth, n_layers: int):
    """Depth within EPS_LAYER of an inner window edge."""
    W = z.shape[1]
    return ((s > 0) & (depth >= z[:, 0] - EPS_LAYER)) | \
        ((s + W < n_layers) & (depth <= z[:, -1] + EPS_LAYER))


def _window_pick(cols_w, w, s, layer):
    """(up, dn) Wachspress sums of a window column at layer-1 and layer,
    zero where that layer lies outside the window."""
    W = cols_w.shape[2]
    lw = layer - s.long()
    up, dn = _pick_two_layers(cols_w, w, torch.clamp(lw - 1, 0, W - 1),
                              torch.clamp(lw, 0, W - 1))
    in_up = (lw - 1 >= 0) & (lw - 1 < W)
    in_dn = (lw >= 0) & (lw < W)
    if up.ndim == 2:
        in_up, in_dn = in_up[:, None], in_dn[:, None]
    return _where0(in_up, up), _where0(in_dn, dn)


def _layer_search_linear_window(z, s, depth, z_surf, z_bot, n_layers: int):
    """Pathline first-hit search over the window's intervals (layers s+1 ..
    s+W-1); not found -> 1.  Returns (layer, ok)."""
    above = depth > z_surf + EPS_LAYER
    below = depth < z_bot - EPS_LAYER
    cond = (depth[:, None] <= z[:, :-1] + EPS_LAYER) & \
           (depth[:, None] >= z[:, 1:] - EPS_LAYER)
    found = torch.any(cond, dim=1)
    first = torch.where(found, s.long() + 1
                        + torch.argmax(cond.to(torch.uint8), dim=1), 1)
    layer = torch.where(above, 1, torch.where(below, n_layers - 1, first))
    return layer, above | below | found


def _window_column(cols_w, w, s, depth, z_surf, z_bot, n_layers, pathline,
                   n_attrs=0):
    """One snapshot's window column of a stage: (hvel, wvel, attrs, ok of
    the search and the lerp, ok_mag of the streamline guard, layer, miss)."""
    ztop_w, vel_w, wvel_w, attrs_w = cols_w
    z = _clamp_profile(torch.einsum("nk,nkw->nw", w, ztop_w), True)
    zs = _window_sentinels(z, s, n_layers)
    if pathline:
        layer, ok_layer = _layer_search_linear_window(z, s, depth, z_surf,
                                                      z_bot, n_layers)
    else:
        layer = _layer_search_binary(zs, depth, z_surf, z_bot)
        ok_layer = torch.ones_like(depth, dtype=torch.bool)
    t, ok_denom = _vertical_lerp_t(zs, layer, depth)
    v_up, v_dn = _window_pick(vel_w, w, s, layer)
    ok_mag = (_norm(v_dn) >= EPS_ZERO) & (_norm(v_up) >= EPS_ZERO)
    hvel = t[:, None] * v_up + (1.0 - t[:, None]) * v_dn
    w_up, w_dn = _window_pick(wvel_w, w, s, layer)
    wvel = t * w_up + (1.0 - t) * w_dn
    att = []
    for ai in range(n_attrs):
        a_up, a_dn = _window_pick(attrs_w[..., ai], w, s, layer)
        att.append(t * a_up + (1.0 - t) * a_dn)
    return (hvel, wvel, att, ok_layer & ok_denom, ok_mag, layer,
            _window_miss(z, s, depth, n_layers))


def _window_rk(eval_at, pos, dt: float, euler: bool, alphas):
    """RK4 (or Euler) over a window stage evaluation eval_at(p, a) ->
    (hvel, wvel, attr, ok, layer, miss).  Returns (new_pos, hvel, wvel, ok,
    attr, the first stage's layer, the OR of the stages' misses)."""
    a1, a2, a4 = alphas
    r = _norm(pos)
    if euler:
        hvel, wvel, attr, ok, layer, miss = eval_at(pos, a1)
        axis = geo.rotation_axis(pos, hvel)
        theta = _norm(hvel) * dt / torch.clamp(r, min=EPS_ZERO)
        return (geo.rotate_around_axis(pos, axis, theta), hvel, wvel, ok,
                attr, layer, miss)
    k1, w1, at1, ok1, layer, m1 = eval_at(pos, a1)
    k2, w2, at2, ok2, _, m2 = eval_at(_advect_on_sphere(pos, k1, dt * 0.5), a2)
    k3, w3, at3, ok3, _, m3 = eval_at(_advect_on_sphere(pos, k2, dt * 0.5), a2)
    k4, w4, at4, ok4, _, m4 = eval_at(_advect_on_sphere(pos, k3, dt), a4)
    hvel = (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
    wvel = (w1 + 2.0 * w2 + 2.0 * w3 + w4) / 6.0
    attr = (at1 + 2.0 * at2 + 2.0 * at3 + at4) / 6.0
    return (_rk4_endpoint(pos, hvel, r, dt), hvel, wvel,
            ok1 & ok2 & ok3 & ok4, attr, layer, m1 | m2 | m3 | m4)


def window_streamline_step(cols_w, z_ends, s, n_layers: int, pos, depth_neg,
                           nv, vpos, dt: float, euler: bool):
    """One streamline step whose stages read only the layer window at s.
    ``cols_w`` = (ztop, vel, wvel, None) window columns (window_cols),
    ``z_ends`` = the (N, K) surface and bottom ztop of the cell's vertices.
    Returns (new_pos, hvel, wvel, ok, layer, miss); the values of miss
    lanes are undefined (the caller recomputes them on the full column)."""
    lane_valid = torch.arange(vpos.shape[1], device=pos.device)[None, :] \
        < nv[:, None]

    def eval_at(p, _a):
        in_mesh = _in_mesh(p, vpos, nv, lane_valid)
        w = wachspress_weights(p, vpos, nv)
        z0 = torch.einsum("nk,nk->n", w, z_ends[0])
        zL = torch.einsum("nk,nk->n", w, z_ends[1])
        hvel, wvel, _, ok_col, ok_mag, layer, miss = _window_column(
            cols_w, w, s, depth_neg, z0, zL, n_layers, False)
        ok = in_mesh & ok_col & ok_mag & (_norm(hvel) >= EPS_ZERO)
        return (_where0(ok[:, None], hvel), _where0(ok, wvel),
                torch.zeros_like(p), ok, layer, miss)

    new_pos, hvel, wvel, ok, _, layer, miss = _window_rk(
        eval_at, pos, dt, euler, (None, None, None))
    return new_pos, hvel, wvel, ok, layer, miss


def window_pathline_step(cols_f_w, cols_b_w, z_ends, s, n_layers: int, pos,
                         depth_neg, nv, vpos, dt: float, alphas, euler: bool,
                         n_attrs: int = 0):
    """One pathline step whose stages read only the layer window at s of
    both snapshots (one start s for both; the front snapshot's surface and
    bottom serve both, as in the TPU kernel).  Returns (new_pos, hvel, wvel,
    ok, attr (N, 3), layer of the front snapshot, miss); the values of miss
    lanes are undefined."""
    lane_valid = torch.arange(vpos.shape[1], device=pos.device)[None, :] \
        < nv[:, None]

    def eval_at(p, a):
        in_mesh = _in_mesh(p, vpos, nv, lane_valid)
        w = wachspress_weights(p, vpos, nv)
        z0 = torch.einsum("nk,nk->n", w, z_ends[0])
        zL = torch.einsum("nk,nk->n", w, z_ends[1])
        hv_f, wv_f, at_f, ok_f, _, layer, miss_f = _window_column(
            cols_f_w, w, s, depth_neg, z0, zL, n_layers, True, n_attrs)
        hv_b, wv_b, at_b, ok_b, _, _, miss_b = _window_column(
            cols_b_w, w, s, depth_neg, z0, zL, n_layers, True, n_attrs)
        hvel = a * hv_b + (1.0 - a) * hv_f
        wvel = a * wv_b + (1.0 - a) * wv_f
        attr = torch.zeros_like(p)
        for ai in range(n_attrs):
            attr[:, ai] = a * at_b[ai] + (1.0 - a) * at_f[ai]
        ok = in_mesh & ok_f & ok_b
        return (_where0(ok[:, None], hvel), _where0(ok, wvel),
                _where0(ok[:, None], attr), ok, layer, miss_f | miss_b)

    return _window_rk(eval_at, pos, dt, euler, alphas)
