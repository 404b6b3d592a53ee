"""Rasterization ops: fixed-depth remap, fixed-layer map, fixed-latitude
section (mirror of mops_tpu.remap).

Vectorized re-implementations of the reference visualizer kernels,
following the CPU/TBB backend's well-defined semantics (the SYCL
fixed-depth kernel reads ztop[-1] out of bounds in its layer-0 path; TBB
clamps -- reference src/CPU/TBB/Kernel/MPASOVisualizerKernels.cpp:403 vs
src/GPU/SYCL/MPASOVisualizerSYCL.cpp:422).

Reference quirk preserved (default): after the layer scan, fixed-depth
remap overrides local_layer to 0 whenever DEPTH <= ztop[0] -- which is true
for any depth below the surface -- so the reference image is always the
average of layer-0/1 velocities with t = 0.5 (TBB kernel :392-412).  Pass
``depth_accurate=True`` for the evidently-intended behavior that uses the
layer found by the scan.

The per-pixel KD lookup stays on the host (scipy cKDTree), where the
reference runs it (SYCLKernel::SearchKDTree is a serial host loop,
src/GPU/SYCL/Kernel/SYCLKernel.cpp:5-22), and is cached per (mesh, image
geometry).  The per-pixel math is torch ops on the field's device, over
fixed-size pixel chunks that stay resident there and are launched back to
back; the images are read back once, after the last chunk.  Pixels whose
cell is -1 (the padded tail of the last chunk) are masked to NaN before any
value of theirs is used: a torch gather would wrap -1 to the last row.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from . import geo
from .advect import _gather_cell_vertices, stacked_vertex_attrs
from .config import EARTH_RADIUS
from .field import Field
from .interp import wachspress_weights
from .mesh import MPASMesh
from .settings import VisualizationSettings
from .solution import SolutionFields
from .step import _clamp_profile, _in_mesh, _weighted_vertex_value
from .utils.timer import TimerManager, timed, timer, wait


def _pixel_positions(cfg: VisualizationSettings) -> np.ndarray:
    """Pixel-center lat/lon -> XYZ for the full image, row 0 = max_lat."""
    w, h = cfg.image_width, cfg.image_height
    ii, jj = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64),
                            indexing="ij")
    lat, lon = geo.pixel_to_latlon_rad(
        ii, jj, w, h, cfg.lat_range[0], cfg.lat_range[1],
        cfg.lon_range[0], cfg.lon_range[1])
    return geo.latlon_rad_to_xyz(lat, lon, EARTH_RADIUS).reshape(-1, 3).numpy()


# pixel -> cell host KD query cache, keyed on (search structure, image
# geometry): at the reference demo size (3601x1801) the 6.5M-pixel query
# is identical across calls and timesteps on the same mesh.  Values keep a
# strong ref to the search object so the id() key stays valid.
_PIXCELL_CACHE: dict = {}
_PIXCELL_CAP = 8


def _geometry_key(field: Field, cfg: VisualizationSettings, kind: str):
    return (kind, id(field.search), cfg.image_width, cfg.image_height,
            tuple(cfg.lat_range), tuple(cfg.lon_range),
            float(cfg.fixed_latitude) if kind == "regrid" else 0.0)


def _pixel_cells(field: Field, cfg: VisualizationSettings, kind: str,
                 make_pixels):
    """(pix, cells) host arrays for this (mesh, image geometry), cached
    across calls."""
    key = _geometry_key(field, cfg, kind)
    hit = _PIXCELL_CACHE.get(key)
    if hit is None:
        pix = make_pixels()
        cells = field.search.query(pix)
        if len(_PIXCELL_CACHE) >= _PIXCELL_CAP:
            _PIXCELL_CACHE.pop(next(iter(_PIXCELL_CACHE)))
        hit = _PIXCELL_CACHE[key] = (field.search, pix, cells)
    return hit[1], hit[2]


def resolve_remap_chunk(chunk: Optional[int], n: int) -> int:
    """Pixel-batch chunk: explicit arg > MOPS_REMAP_CHUNK env > 262144.

    Bounds the per-chunk transients: the (chunk, K, L) ztop gather is
    1.0 GB at float64 for 262,144 pixels, K = 8, L = 60, where one pass
    over the reference demo's 6,485,401 pixels (reference CLI/main.cpp:137:
    3601x1801) would take 24.9 GB.  0 disables chunking."""
    if chunk is None:
        chunk = int(os.environ.get("MOPS_REMAP_CHUNK", 262144))
    return chunk


# device-resident chunked pixel grids keyed like _PIXCELL_CACHE + chunk,
# dtype and device, so repeat remaps skip the host KD query and the upload
_DEVPIX_CACHE: dict = {}


@timed("remap.pixels", "CPUCompute")
def _device_pixel_chunks(field: Field, cfg: VisualizationSettings,
                         kind: str, make_pixels, chunk: int):
    """((C, chunk, 3) pix, (C, chunk) cells, n) on the field's device in its
    dtype, cached.  The tail is padded with the last pixel and cell -1;
    ``chunk`` 0 or >= n gives one unpadded chunk.  A span, remap.pixels; a
    miss of the cache counts remap.pixel_cache_miss."""
    mesh, _ = field.device_tables()
    key = _geometry_key(field, cfg, kind) + (chunk, str(mesh.dtype),
                                             str(mesh.device))
    hit = _DEVPIX_CACHE.get(key)
    if hit is None:
        TimerManager.instance().add("remap.pixel_cache_miss")
        pix, cells = _pixel_cells(field, cfg, kind, make_pixels)
        n = pix.shape[0]
        size = chunk if chunk and n > chunk else n
        pad = (-n) % size
        pix_d = torch.from_numpy(pix).to(device=mesh.device, dtype=mesh.dtype)
        cells_d = torch.from_numpy(np.asarray(cells, dtype=np.int32)).to(
            mesh.device)
        if pad:
            pix_d = torch.cat([pix_d, pix_d[-1:].expand(pad, 3)])
            cells_d = torch.cat([cells_d, cells_d.new_full((pad,), -1)])
        c = pix_d.shape[0] // size
        if len(_DEVPIX_CACHE) >= _PIXCELL_CAP:
            _DEVPIX_CACHE.pop(next(iter(_DEVPIX_CACHE)))
        hit = _DEVPIX_CACHE[key] = (field.search, pix_d.reshape(c, size, 3),
                                    cells_d.reshape(c, size), n)
    return hit[1], hit[2], hit[3]


def _run_chunked(batch_fn, chunks, n: int):
    """Evaluate batch_fn(*(x[c] for x in chunks)) -> tuple of (chunk, ...)
    tensors (or None) over every chunk c of the (C, chunk, ...) inputs,
    back to back with no read-back in between; returns the outputs
    concatenated and trimmed to the first ``n`` rows, on the device.
    batch_fn must treat cell = -1 as a NaN/invalid pixel (all three batch
    functions do)."""
    outs = [batch_fn(*(x[c] for x in chunks))
            for c in range(chunks[0].shape[0])]
    return tuple(None if parts[0] is None else torch.cat(parts)[:n]
                 for parts in zip(*outs))


def _cell_geometry(mesh: MPASMesh, cell: torch.Tensor):
    """(cell_ok, vids, nv, lane_valid, vids_ok, vpos) with out-of-range
    cells gathered as cell 0 and flagged in cell_ok."""
    cell_ok = (cell >= 0) & (cell < mesh.n_cells)
    vids, nv, vids_ok = _gather_cell_vertices(
        mesh, torch.where(cell_ok, cell, torch.zeros_like(cell)))
    K = vids.shape[1]
    lane_valid = torch.arange(K, device=cell.device)[None, :] < nv[:, None]
    return cell_ok, vids, nv, lane_valid, vids_ok, mesh.vertex_xyz[vids.long()]


def _first_hit(cond: torch.Tensor):
    """(found, first True index + 1) over the intervals of a (N, L-1) mask."""
    return (torch.any(cond, dim=1),
            torch.argmax(cond.to(torch.uint8), dim=1) + 1)


def _nan_outside(ok: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    return torch.where(ok[:, None], img, torch.full_like(img, float("nan")))


def _fixed_depth_core(mesh: MPASMesh, sol: SolutionFields, attrs, pos, cell,
                      depth_neg, *, depth_accurate: bool, use_attrs: bool):
    """Per-pixel fixed-depth evaluation (TBB kernel :288-469)."""
    cell_ok, vids, nv, lane_valid, vids_ok, vpos = _cell_geometry(mesh, cell)
    in_mesh = _in_mesh(pos, vpos, nv, lane_valid) & cell_ok & vids_ok

    w = wachspress_weights(pos, vpos, nv)
    z = torch.einsum("nk,nkl->nl", w, sol.vertex_ztop[vids.long()])
    z = _clamp_profile(z, True)
    L = z.shape[1]

    z_surf = torch.maximum(z[:, 0], z[:, -1])
    z_bot = torch.minimum(z[:, 0], z[:, -1])
    epsd = torch.clamp(1e-8 * torch.abs(z_surf - z_bot), min=1e-6)
    in_column = (depth_neg <= z_surf + epsd) & (depth_neg >= z_bot - epsd)

    top = torch.maximum(z[:, :-1], z[:, 1:])
    bot = torch.minimum(z[:, :-1], z[:, 1:])
    found, first = _first_hit((depth_neg[:, None] <= top + 1e-8)
                              & (depth_neg[:, None] >= bot - 1e-8))
    layer = torch.where(found, first, -1)
    if not depth_accurate:
        # reference override (TBB kernel :392-394)
        layer = torch.where(depth_neg <= z[:, 0], 0, layer)
    ok = in_mesh & in_column & (layer >= 0)
    layer = torch.clamp(layer, 0, L - 1)

    top_i = z.gather(1, torch.clamp(layer - 1, min=0)[:, None])[:, 0]
    bot_i = z.gather(1, layer[:, None])[:, 0]
    top_s = torch.maximum(top_i, bot_i)
    bot_s = torch.minimum(top_i, bot_i)
    denom = top_s - bot_s
    t = torch.where(denom > 1e-12,
                    (depth_neg - bot_s) / torch.where(
                        denom == 0, torch.ones_like(denom), denom),
                    torch.full_like(denom, 0.5))

    jt = torch.clamp(layer - 1, 0, L - 1)
    jb = torch.clamp(jt + 1, max=L - 1)
    v_top = _weighted_vertex_value(sol.vertex_velocity, vids, jt, w)
    v_bot = _weighted_vertex_value(sol.vertex_velocity, vids, jb, w)
    top0 = (torch.linalg.vector_norm(v_top, dim=-1) < 1e-12)[:, None]
    bot0 = (torch.linalg.vector_norm(v_bot, dim=-1) < 1e-12)[:, None]
    lerp = (1.0 - t[:, None]) * v_bot + t[:, None] * v_top
    final_vel = torch.where(top0 & bot0, torch.zeros_like(lerp),
                            torch.where(top0, v_bot,
                                        torch.where(bot0, v_top, lerp)))

    u_east, v_north = geo.xyz_velocity_to_enu(pos, final_vel)
    spd = torch.sqrt(u_east ** 2 + v_north ** 2)
    vel_img = _nan_outside(ok, torch.stack([u_east, v_north, spd], dim=-1))

    attr_img = None
    if use_attrs and attrs is not None:
        # All active attributes (reference MAX_ATTRS=8); the caller fans them
        # out into ceil(A/3) three-channel images like MOPSApp::runRemapping
        # (reference src/Core/MOPSApp.cpp:176-185).
        aj = torch.clamp(layer - 1, 0, attrs.shape[1] - 1)
        vals = [_weighted_vertex_value(attrs[..., ai], vids, aj, w)
                for ai in range(min(attrs.shape[-1], 8))]
        while len(vals) % 3:
            vals.append(torch.zeros_like(spd))
        attr_img = _nan_outside(ok, torch.stack(vals, dim=-1))  # (N, 3*ceil(A/3))
    return vel_img, attr_img


def run_remapping(field: Field, cfg: VisualizationSettings,
                  depth_accurate: bool = False,
                  chunk: Optional[int] = None) -> List[np.ndarray]:
    """Fixed-depth remap -> [velocity image (h, w, 3), attr images...].

    Mirrors MOPSApp::runRemapping + TBB VisualizeFixedDepth: image[0]
    carries (u_east, v_north, speed); images[1..] pack the active named
    attributes (name order) three per image, ceil(nAttrs/3) images total,
    unused channels zero (reference src/Core/MOPSApp.cpp:171-196 allocates
    the groups; the TBB kernel :238-471 fills attrs 0-1 of group 0 -- this
    build fills every group).  The pixels are evaluated in fixed-size chunks
    (see resolve_remap_chunk) on the field's device and the host pixel->cell
    KD query is cached per (mesh, image geometry).  Spans: remap.pixels,
    remap.launch (the chunks' launches, GPUKernel: the device's stream
    time), remap.wait (the host waiting for them, Other) and
    remap.readback (the images to the host, MemoryCopy)."""
    mesh, sol = field.device_tables()
    w, h = cfg.image_width, cfg.image_height
    n_pix = w * h
    pix_c, cells_c, n = _device_pixel_chunks(
        field, cfg, "remap", lambda: _pixel_positions(cfg),
        resolve_remap_chunk(chunk, n_pix))
    use_attrs = len(sol.cell_attrs) > 0   # attr_size > 0 -> groups (reference)
    attrs = stacked_vertex_attrs(sol) if use_attrs else None
    depth = -float(cfg.fixed_depth)

    def batch(p, c):
        dn = torch.full((p.shape[0],), depth, dtype=p.dtype, device=p.device)
        return _fixed_depth_core(mesh, sol, attrs, p, c, dn,
                                 depth_accurate=depth_accurate,
                                 use_attrs=use_attrs)

    with timer("remap.launch", "GPUKernel", device=mesh.device):
        vel_img, attr_img = _run_chunked(batch, (pix_c, cells_c), n)
    with timer("remap.wait", "Other"):
        wait(mesh.device)
    with timer("remap.readback", "MemoryCopy"):
        vel_img = vel_img.cpu().numpy()
        attr_img = None if attr_img is None else attr_img.cpu().numpy()
    out = [vel_img.reshape(h, w, 3)]
    if attr_img is not None:
        groups = attr_img.reshape(h, w, -1)
        for g in range(groups.shape[-1] // 3):
            out.append(groups[..., 3 * g:3 * g + 3])
    return out


def _fixed_layer_batch(mesh: MPASMesh, sol: SolutionFields, pos, cell,
                       layer: int):
    """Per-pixel fixed-layer evaluation (TBB VisualizeFixedLayer :141-236)."""
    cell_ok, vids, nv, lane_valid, vids_ok, vpos = _cell_geometry(mesh, cell)
    ok = _in_mesh(pos, vpos, nv, lane_valid) & cell_ok & vids_ok
    w = wachspress_weights(pos, vpos, nv)
    vel = _weighted_vertex_value(sol.vertex_velocity, vids,
                                 torch.full_like(cell, layer), w)
    u_east, v_north = geo.xyz_velocity_to_enu(pos, vel)
    return _nan_outside(ok, torch.stack(
        [u_east, v_north, torch.zeros_like(u_east)], dim=-1))


def run_fixed_layer(field: Field, cfg: VisualizationSettings,
                    chunk: Optional[int] = None) -> np.ndarray:
    """Fixed-layer map -> (h, w, 3) image of (zonal, meridional, 0)."""
    mesh, sol = field.device_tables()
    w, h = cfg.image_width, cfg.image_height
    pix_c, cells_c, n = _device_pixel_chunks(
        field, cfg, "remap", lambda: _pixel_positions(cfg),
        resolve_remap_chunk(chunk, w * h))
    layer = int(np.clip(cfg.fixed_layer, 0, sol.n_layers - 1))
    (img,) = _run_chunked(
        lambda p, c: (_fixed_layer_batch(mesh, sol, p, c, layer),),
        (pix_c, cells_c), n)
    return img.cpu().numpy().reshape(h, w, 3)


def _is_land_sign_test(mesh: MPASMesh, pos, cell):
    """MPASOField::isOnOcean's sign-consistency test (reference
    src/Core/MPASOField.cpp:36-81): d_k = dot(cross(A,B), p - A); land when
    the signs of d_k disagree.  (The reference name is inverted: it returns
    true ON LAND.)  Kept in the reference's untranslated form: it is a sign
    test."""
    _, _, nv, lane_valid, _, vpos = _cell_geometry(mesh, cell)
    K = vpos.shape[1]
    lane = torch.arange(K, device=pos.device)[None, :]
    nxt = torch.where(lane + 1 >= nv[:, None], 0, lane + 1)
    b = vpos.gather(1, nxt[..., None].expand(vpos.shape))
    normal = torch.linalg.cross(-vpos, -b, dim=-1)       # cross(O-A, O-B)
    d = torch.sum(normal * (pos[:, None, :] - vpos), dim=-1)
    one = torch.ones_like(d)
    sign0 = torch.where(d[:, 0] > 0, one[:, 0], -one[:, 0])
    signs = torch.where(d > 0, one, -one)
    return torch.any(lane_valid & (signs != sign0[:, None]), dim=1)


def _fixed_lat_batch(mesh: MPASMesh, sol: SolutionFields, pos, cell,
                     depth_neg):
    """Per-pixel fixed-latitude section (TBB VisualizeFixedLatitude
    :473-651)."""
    cell_ok, vids, nv, _, vids_ok, vpos = _cell_geometry(mesh, cell)
    ok = cell_ok & vids_ok & ~_is_land_sign_test(mesh, pos, cell)

    w = wachspress_weights(pos, vpos, nv)
    z = torch.einsum("nk,nkl->nl", w, sol.vertex_ztop[vids.long()])
    z = _clamp_profile(z, True)
    L = z.shape[1]

    eps = 1e-6
    in_col = (depth_neg <= z[:, 0] + eps) & (depth_neg >= z[:, -1] - eps)
    top = torch.maximum(z[:, :-1], z[:, 1:])
    bot = torch.minimum(z[:, :-1], z[:, 1:])
    found, layer = _first_hit((depth_neg[:, None] <= top + eps)
                              & (depth_neg[:, None] >= bot - eps))
    ok = ok & in_col & found
    layer = torch.clamp(layer, 1, L - 1)

    z_dn = z.gather(1, layer[:, None])[:, 0]
    z_up = z.gather(1, (layer - 1)[:, None])[:, 0]
    up_s = torch.maximum(z_up, z_dn)
    dn_s = torch.minimum(z_up, z_dn)
    denom = up_s - dn_s
    ok = ok & (torch.abs(denom) >= 1e-30)
    t = (depth_neg - dn_s) / torch.where(denom == 0, torch.ones_like(denom),
                                         denom)

    v_up = _weighted_vertex_value(sol.vertex_velocity, vids, layer - 1, w)
    v_dn = _weighted_vertex_value(sol.vertex_velocity, vids, layer, w)
    vel = (1.0 - t[:, None]) * v_dn + t[:, None] * v_up
    u_east, v_north = geo.xyz_velocity_to_enu(pos, vel)
    return _nan_outside(ok, torch.stack(
        [u_east, v_north, torch.zeros_like(u_east)], dim=-1))


def _regrid_positions(cfg: VisualizationSettings, h: int) -> np.ndarray:
    """(h*w, 3) XYZ of the section's pixels: every row at the fixed latitude,
    columns spanning the lon range."""
    w = cfg.image_width
    min_lon, max_lon = cfg.lon_range
    j_step = (max_lon - min_lon) / (w - 1) if w > 1 else 0.0
    jj = torch.arange(w, dtype=torch.float64).expand(h, w)
    lon = torch.deg2rad(min_lon + jj * j_step)
    lat = torch.full_like(lon, float(np.deg2rad(cfg.fixed_latitude)))
    return geo.latlon_rad_to_xyz(lat, lon, EARTH_RADIUS).reshape(-1, 3).numpy()


def regrid_depths(mesh: MPASMesh, h: int) -> np.ndarray:
    """(h,) float64 -|depth| of the section's rows: refBottomDepth.front()
    to .back() in h even steps."""
    if mesh.ref_bottom_depth is None:
        raise ValueError("regrid requires refBottomDepth")
    rbd = mesh.ref_bottom_depth.double().cpu().numpy()
    min_depth, max_depth = float(rbd[0]), float(rbd[-1])
    i_step = (max_depth - min_depth) / (h - 1) if h > 1 else 0.0
    return -np.abs(min_depth + np.arange(h) * i_step)


def run_regrid(field: Field, cfg: VisualizationSettings,
               chunk: Optional[int] = None) -> np.ndarray:
    """Fixed-latitude depth x longitude section -> (h, w, 3) image.

    Depth rows span refBottomDepth.front()..back(); columns span the lon
    range (reference TBB VisualizeFixedLatitude :473-651, exposed as
    MOPS_RunReGrid via tools/pyMOPS/bindings.cpp:305-312)."""
    mesh, sol = field.device_tables()
    w, h = cfg.image_width, cfg.image_height
    depth_neg = torch.from_numpy(np.repeat(regrid_depths(mesh, h), w)).to(
        device=mesh.device, dtype=mesh.dtype)
    pix_c, cells_c, n = _device_pixel_chunks(
        field, cfg, "regrid", lambda: _regrid_positions(cfg, h),
        resolve_remap_chunk(chunk, w * h))
    depth_neg = torch.cat([depth_neg, depth_neg.new_zeros(
        cells_c.numel() - n)]).reshape(cells_c.shape)
    (img,) = _run_chunked(
        lambda p, c, d: (_fixed_lat_batch(mesh, sol, p, c, d),),
        (pix_c, cells_c, depth_neg), n)
    return img.cpu().numpy().reshape(h, w, 3)
