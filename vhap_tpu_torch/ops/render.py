"""Render pipelines, in image layout.

Counterpart of vhap_tpu/ops/render.py. Its two paths:

* The tracker's energies (`rasterize_mesh(..., with_attrs=False)` +
  `render_rgba`, reference: vhap/util/render_nvdiffrast.py:216-245,
  354-484): visibility (K1) -> vertex normals -> one packed face table ->
  fused interpolation (K2f, backward K2b) -> mip-mapped texture (K3,
  backward K4) -> SH shading -> background compositing -> cluster
  disturbance -> antialias. The training step adds three features of the
  same function: the region texture-gradient detach (a flag row of the face
  table), the boundary-detached antialias planes, and the cluster
  disturbance (the adaptive appearance prior, `impl='sample'`; its cluster
  ids ride the face table as a second flag row).
* The visualization render (`render_rgba_vis`, reference:
  vhap/util/render_nvdiffrast.py:486-567), through the nvdiffrast-style
  API: `rasterize` (visibility K1 + per-pixel planes, K6) ->
  `interpolate` (K6) -> texture (K3) -> shading -> antialias (K6).

The color chain is float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from vhap_tpu_torch.device import constant
from vhap_tpu_torch.ops import camera as cam
from vhap_tpu_torch.ops.antialias import AA_PLANE_KEYS, antialias, antialias_rast
from vhap_tpu_torch.ops.interp import (fused_interp, fused_interp_plain,
                                      split_channels)
from vhap_tpu_torch.ops.plane_gather import plane_gather, plane_gather_plain
from vhap_tpu_torch.ops.rasterize import (PLANE_KEYS, face_attribute_planes,
                                          interpolate, rasterize, visibility,
                                          visibility_plain)
from vhap_tpu_torch.ops.shading import (compute_face_normals,
                                        compute_v_normals, safe_normalize,
                                        shade)
from vhap_tpu_torch.ops.texture import texture_sample
from vhap_tpu_torch.parallel import sharding
from vhap_tpu_torch.util.profiling import span


@dataclass(frozen=True)
class RenderSettings:
    """The fields of vhap_tpu's RenderSettings that the port reads.

    use_kernels=False runs the plain PyTorch version of every kernel
    instead, on any device: the reference the kernels are held against on
    the card. disturb_impl 'auto' and 'sample' run the sampling
    disturbance; 'pairswap' is a TPU variant the port does not carry.
    """
    lighting_type: str = "SH"
    lighting_space: str = "world"
    disturb_rate_fg: Optional[float] = 0.5
    disturb_rate_bg: Optional[float] = 0.5
    cull_backfaces: bool = True
    disturb_pool_stride: int = 1
    disturb_impl: str = "auto"
    antialias: bool = True
    use_kernels: bool = True


def rasterize_mesh(verts, faces, RT, K, image_size, settings: RenderSettings,
                   grad_enabled: bool = True, with_attrs: bool = True) -> Dict:
    """World-space mesh -> fragment buffers
    (vhap/util/render_nvdiffrast.py:216-245).

    with_attrs=True adds `rasterize`'s rast / rast_db buffers (gradients to
    the vertices unless grad_enabled=False); with_attrs=False stops at
    visibility, since render_rgba's fused pass computes the per-pixel
    attributes itself.
    """
    verts_camera = cam.world_to_camera(verts, RT)
    verts_clip = cam.camera_to_clip(verts_camera, K, image_size)
    out = dict(verts=verts, verts_camera=verts_camera[..., :3],
               verts_clip=verts_clip)
    with span("render.raster"):
        if with_attrs:
            rast, rast_db, tri_id, overflow = rasterize(
                verts_clip, faces, tuple(image_size), settings.cull_backfaces,
                grad_enabled, with_overflow=True, use_kernels=settings.use_kernels)
            out.update(rast=rast, rast_db=rast_db)
        else:
            H, W = image_size
            vis = visibility if settings.use_kernels else visibility_plain
            tri_id, overflow = vis(verts_clip.detach(), faces, H, W,
                                   settings.cull_backfaces)
    out.update(tri_id=tri_id, overflow=overflow)
    return out


def pack_face_tables(verts_clip, space_verts, faces, verts_uv, faces_uv,
                     flag_rows: Sequence[torch.Tensor] = (),
                     verts_clip_aa: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The (B, 36 + nf, F) face table the fused interpolation reads, in the
    corner-table order of vhap_tpu/ops/render.py:602-656: the 12 PLANE_KEYS
    rows, 9 corner normals, 6 corner uvs, 3 corner vertex ids, the nf
    (1, 1, F) flag rows and the 6 antialias planes. The antialias planes
    come from `verts_clip_aa` (the boundary-detached clip vertices) when
    given, else they are the first 6 PLANE_KEYS rows again."""
    B = verts_clip.shape[0]
    F = faces.shape[0]
    if faces_uv.shape[0] != F:   # as vhap_tpu/ops/render.py:608's reshape
        raise ValueError(
            f"{faces_uv.shape[0]} uv faces for {F} faces: the train render needs "
            "one uv row per face (connect_lip_inside and remove_torso leave "
            "textures_idx out of step, a reference quirk of model/surgery.py)")
    v_normal = compute_v_normals(space_verts, faces)
    nrm_tab = v_normal[:, faces].permute(0, 2, 3, 1).reshape(B, 9, F)
    uv_tab = verts_uv[faces_uv].permute(1, 2, 0).reshape(1, 6, F)
    vid_tab = faces.T[None].to(torch.float32)                 # (1, 3, F)
    p = face_attribute_planes(verts_clip, faces)
    p_aa = p if verts_clip_aa is None else face_attribute_planes(verts_clip_aa, faces)
    return torch.cat([
        torch.stack([p[k] for k in PLANE_KEYS], dim=1),
        nrm_tab,
        uv_tab.expand(B, 6, F),
        vid_tab.expand(B, 3, F),
    ] + [r.expand(B, 1, F) for r in flag_rows] + [
        torch.stack([p_aa[k] for k in AA_PLANE_KEYS], dim=1),
    ], dim=1).contiguous()


def face_tables(rast_dict: Dict, faces, verts_uv, faces_uv,
                settings: RenderSettings, align_texture_face_mask=None,
                align_boundary_vert_mask=None, fid2cid=None
                ) -> Tuple[torch.Tensor, int]:
    """render_rgba's packed face table and its number of flag rows: the
    align-texture face mask (when given) and the cluster ids (when fid2cid
    is given, i.e. the disturbance is on), in that order
    (vhap_tpu/ops/render.py:613-627)."""
    verts_clip = rast_dict["verts_clip"]
    dev = verts_clip.device
    space_verts = (rast_dict["verts"] if settings.lighting_space == "world"
                   else rast_dict["verts_camera"])
    flag_rows: List[torch.Tensor] = []
    if align_texture_face_mask is not None:
        flag_rows.append(torch.as_tensor(align_texture_face_mask, device=dev)[1:]
                         .to(torch.float32)[None, None])
    if fid2cid is not None:
        flag_rows.append(torch.as_tensor(fid2cid, device=dev)[1:]
                         .to(torch.float32)[None, None])
    verts_clip_aa = None
    if align_boundary_vert_mask is not None:
        m = torch.as_tensor(align_boundary_vert_mask, device=dev)[None, :, None]
        verts_clip_aa = torch.where(m, verts_clip.detach(), verts_clip)
    packed = pack_face_tables(verts_clip, space_verts, faces, verts_uv,
                              faces_uv, flag_rows, verts_clip_aa)
    return packed, len(flag_rows)


# ---------------------------------------------------------------------------
# Cluster disturbance (vhap_tpu/ops/render.py:213-400)
# ---------------------------------------------------------------------------

def _pack_cid_rgb_u8(cid, rgb):
    """(N,) cluster id + (N, 3) colors -> one self-keyed sortable int32
    cid<<24 | r<<16 | g<<8 | b (cid < 128): each channel quantized to 8
    bits over [0, 2) (torch.round, like jnp.round, rounds half to even)."""
    q = torch.round(torch.clamp(rgb.to(torch.float32), 0.0, 2.0)
                    * 127.5).to(torch.int32)
    return ((cid.to(torch.int32) << 24) | (q[:, 0] << 16) | (q[:, 1] << 8)
            | q[:, 2])


def _unpack_rgb_u8(key, dtype=torch.float32):
    """Packed keys (N,) -> (N, 3) colors."""
    return torch.stack([(key >> 16) & 255, (key >> 8) & 255, key & 255],
                       dim=1).to(dtype) * (1.0 / 127.5)


def _disturbance_swap_mask(generator, cid, rate_fg, rate_bg):
    """(N,) bool: which pixels receive a swapped-in value this step
    (Bernoulli per pixel at its cluster's rate; cluster 1 untouched)."""
    N, dev = cid.shape[0], cid.device
    none = torch.zeros(N, dtype=torch.bool, device=dev)
    w_fg = (torch.rand(N, generator=generator, device=dev) < rate_fg
            if rate_fg is not None else none)
    w_bg = (torch.rand(N, generator=generator, device=dev) < rate_bg
            if rate_bg is not None else none)
    return torch.where(cid == 0, w_bg, w_fg) & (cid != 1)


def _cluster_disturbance(rgba, rgba_bg, cid, generator, rate_fg, rate_bg,
                         num_clusters: int, pool_stride: int = 1,
                         sample_weight=None, impl: str = "sample"):
    """Adaptive appearance prior: swap pixels within semantic clusters
    (vhap/util/render_nvdiffrast.py:424-460; vhap_tpu/ops/render.py:269-400,
    `impl='sample'`).

    Every pixel is, with probability `rate` (rate_fg on clusters >= 2,
    rate_bg on cluster 0, background), replaced by a random detached pixel
    of its own cluster sampled across the whole batch; cluster 1
    (unclustered foreground) is never disturbed. Alpha is untouched: a
    same-cluster sample has the destination's alpha. The sampling sorts a
    (block-subsampled, `pool_stride`) pool of packed cluster-id + color
    keys, finds each cluster's range by searchsorted and draws a uniform
    index into the pixel's own range. `sample_weight` (B,) excludes
    weight-0 padded frames from the pool: their pixels get the sentinel
    cluster `num_clusters`, which sorts past every real range. Random
    numbers come from `generator`.

    Under a process group (parallel/sharding.py) the pool is the whole
    batch's, as JAX's sort over the global batch: each rank's subsampled
    keys are gathered (int32, no gradient) before the sort, and each rank
    samples from it for its own pixels with its own generator.
    """
    if impl == "pairswap":
        raise NotImplementedError(
            "disturb_impl='pairswap' is a TPU sampling variant that "
            "vhap_tpu_torch does not port (ROADMAP.md 'Not to port'); use "
            "'auto' or 'sample'")
    if impl != "sample":
        raise ValueError(f"unknown disturbance impl {impl!r}")
    if num_clusters + 1 >= 128:
        raise ValueError(f"{num_clusters} clusters do not fit the 7-bit key")
    B, H, W, _ = rgba.shape
    N, dev = B * H * W, rgba.device
    rgb = rgba[..., :3].reshape(N, 3)
    cid = cid.reshape(N)
    pool_cid = cid
    if sample_weight is not None:
        valid = (sample_weight > 0)[:, None, None].expand(B, H, W).reshape(N)
        pool_cid = torch.where(valid, cid, torch.full_like(cid, num_clusters))
    # swap sources are detached (render_nvdiffrast.py:451)
    mixed = torch.where((cid == 0)[:, None], rgba_bg[..., :3].reshape(N, 3),
                        rgb).detach()
    keys = _pack_cid_rgb_u8(pool_cid, mixed)
    if pool_stride > 1:
        # block-contiguous subsample: the first 128 of every
        # 128 * pool_stride flat pixels
        g = N // (128 * pool_stride)
        keys = keys[:g * 128 * pool_stride].reshape(
            g, pool_stride, 128)[:, 0].reshape(-1)
    keys = sharding.all_gather_rows(keys, "disturb_pool")   # the whole batch's pool
    if keys.numel() == 0:
        return rgba                      # an empty pool swaps nothing
    sorted_keys = torch.sort(keys).values
    # every key of cluster c lies in [c<<24, (c+1)<<24)
    bounds = torch.arange(num_clusters + 1, dtype=torch.int32,
                          device=dev) << 24
    edges = torch.searchsorted(sorted_keys, bounds, right=False)
    offsets, counts = edges[:-1], edges[1:] - edges[:-1]

    cid_l = cid.long()
    cnt = counts[cid_l]
    # cnt > 0: a tiny cluster the pool stride dropped keeps its own pixel
    w_bool = _disturbance_swap_mask(generator, cid, rate_fg, rate_bg) & (cnt > 0)
    r = torch.randint(0, 2**31 - 1, (N,), generator=generator,
                      device=dev) % torch.clamp(cnt, min=1)
    idx = torch.where(w_bool, offsets[cid_l] + r, torch.zeros_like(r))
    src = _unpack_rgb_u8(sorted_keys[idx], dtype=rgb.dtype)
    w = w_bool.to(rgb.dtype)[:, None]
    out = src * w + rgb * (1.0 - w)
    return torch.cat([out.reshape(B, H, W, 3), rgba[..., 3:]], dim=-1)


def render_rgba(
    rast_dict: Dict,
    faces: torch.Tensor,
    verts_uv: torch.Tensor,           # (Vt, 2), v already flipped by caller
    faces_uv: torch.Tensor,           # (F, 3)
    tex: torch.Tensor,                # (1, C, T, T) channel-first like ref
    lights: Optional[torch.Tensor],   # (B|1, 9, 3)
    settings: RenderSettings,
    background_color: Union[Sequence[float], torch.Tensor] = (1.0, 1.0, 1.0),
    align_texture_face_mask=None,     # (F+1,) bool, bg-padded face ids
    align_boundary_vert_mask=None,    # (V,) bool
    enable_disturbance: bool = False,
    fid2cid=None,                     # (F+1,) int, bg-padded face ids
    num_clusters: int = 0,
    generator: Optional[torch.Generator] = None,
    sample_weight: Optional[torch.Tensor] = None,   # (B,) 0 = padded
) -> Dict[str, torch.Tensor]:
    """Training render path (vhap/util/render_nvdiffrast.py:354-484).
    Returns (B, H, W, C) buffers flipped to image orientation (row 0 =
    top), like the reference's final `.flip(1)` outputs; with the
    disturbance on, also "cid" (B, H, W, 1), each pixel's cluster id."""
    if enable_disturbance and (fid2cid is None or generator is None):
        raise ValueError("the cluster disturbance needs fid2cid and a "
                         "torch.Generator")
    tri_id = rast_dict["tri_id"]
    fg_mask = (tri_id > 0)[..., None]

    with span("render.interp"):
        packed, n_flags = face_tables(
            rast_dict, faces, verts_uv, faces_uv, settings,
            align_texture_face_mask, align_boundary_vert_mask,
            fid2cid if enable_disturbance else None)
        if settings.use_kernels:
            ch, plane_overflow = fused_interp(packed, tri_id, n_flags)
        else:
            chans, plane_overflow = fused_interp_plain(packed, tri_id, n_flags)
            ch = split_channels(chans, n_flags)
    zw = ch.zw
    texc = ch.texc.permute(0, 2, 3, 1)
    texd = ch.texd.permute(0, 2, 3, 1)
    normal = ch.normal.permute(0, 2, 3, 1)
    vid_planes = list(ch.vids.to(torch.int32).unbind(1))
    flag_planes = list(ch.flags.unbind(1))
    aa_planes = list(ch.aa.unbind(1))
    out: Dict[str, torch.Tensor] = {"plane_overflow": plane_overflow}

    # ---- texture (region-masked gradient, render_nvdiffrast.py:389-399) ----
    if align_texture_face_mask is not None:
        pix_mask = ((flag_planes[0] > 0.5) & fg_mask[..., 0])[..., None]
        flag_planes = flag_planes[1:]
        texc = torch.where(pix_mask, texc.detach(), texc)
    with span("render.texture"):
        albedo = texture_sample(tex.permute(0, 2, 3, 1), texc, texd,
                                mask=fg_mask[..., 0], use_kernels=settings.use_kernels)

    diffuse = shade(normal, settings.lighting_type, lights)
    diffuse_detach_normal = shade(normal.detach(), settings.lighting_type, lights)

    rgb = albedo * diffuse
    alpha = fg_mask.to(rgb.dtype)
    rgba = torch.cat([rgb, alpha], dim=-1)

    # ---- background (render_nvdiffrast.py:409-421) ----
    if isinstance(background_color, (list, tuple)):
        rgba_bg = constant(tuple(background_color) + (0.0,), rgba.dtype,
                           rgba.device).expand(rgba.shape)
    else:
        bg = background_color.to(rgba.dtype)
        rgba_bg = torch.cat([bg, torch.zeros_like(bg[..., :1])], dim=-1)
        rgba_bg = rgba_bg.expand(rgba.shape)
    rgba_bg = torch.flip(rgba_bg, dims=[1])  # gl buffers are bottom-up
    rgba = torch.where(fg_mask, rgba, rgba_bg)

    # ---- adaptive appearance prior (render_nvdiffrast.py:424-460) ----
    if enable_disturbance:
        cid = torch.where(fg_mask[..., 0], flag_planes[0].to(torch.int32), 0)
        out["cid"] = torch.flip(cid, dims=[1])[..., None].to(torch.float32)
        with span("render.disturb"):
            rgba = _cluster_disturbance(
                rgba, rgba_bg, cid, generator, settings.disturb_rate_fg,
                settings.disturb_rate_bg, num_clusters,
                settings.disturb_pool_stride, sample_weight=sample_weight,
                impl="pairswap" if settings.disturb_impl == "pairswap"
                else "sample")

    # ---- antialias (render_nvdiffrast.py:463-466; boundary-detach is in
    # the AA planes of the face table already) ----
    if settings.antialias:
        with span("render.antialias"):
            rgba_aa = antialias(rgba, tri_id, zw, vid_planes, aa_planes)
    else:
        rgba_aa = rgba
    aa = torch.any(rgba != rgba_aa, dim=-1, keepdim=True).to(rgba.dtype)

    def flip(x):
        return torch.flip(x, dims=[1])

    out.update({
        "albedo": flip(albedo),
        "normal": flip(normal),
        "diffuse": flip(diffuse),
        "diffuse_detach_normal": flip(diffuse_detach_normal),
        "rgba": flip(rgba_aa),
        "aa": flip(aa.expand(aa.shape[:3] + (3,))),
    })
    return out


def _uv_tables_for(faces, verts_uv, faces_uv):
    """A uv-face table with a row for every face. connect_lip_inside adds
    faces and no uv rows (a reference quirk, model/surgery.py): the JAX
    package's per-pixel gather fills the missing rows' corners with NaN, so
    those faces get a NaN uv row here, read in bounds; the sampler skips
    their pixels (masked, uv 0) and their albedo is NaN, as in JAX. Returns (verts_uv,
    faces_uv, whether rows were missing)."""
    n_short = faces.shape[0] - faces_uv.shape[0]
    if n_short <= 0:
        return verts_uv, faces_uv, False
    nan_row = torch.full((1, 2), float("nan"), dtype=verts_uv.dtype,
                         device=verts_uv.device)
    fill = torch.full((n_short, 3), verts_uv.shape[0], dtype=faces_uv.dtype,
                      device=faces_uv.device)
    return torch.cat([verts_uv, nan_row]), torch.cat([faces_uv, fill]), True


def render_rgba_vis(
    verts, faces, RT, K, image_size,
    settings: RenderSettings,
    background_color: Sequence[float] = (1.0, 1.0, 1.0),
    v_color: Optional[torch.Tensor] = None,     # (V, 3) or (B|1, V, 3)
    verts_uv: Optional[torch.Tensor] = None,    # (Vt, 2), v already flipped
    faces_uv: Optional[torch.Tensor] = None,    # (F, 3)
    tex: Optional[torch.Tensor] = None,         # (1, C, T, T)
    lights: Optional[torch.Tensor] = None,      # (B|1, 9, 3)
    shade_smooth: bool = True,
) -> Dict[str, torch.Tensor]:
    """Visualization render path (vhap/util/render_nvdiffrast.py:486-567;
    vhap_tpu/ops/render.py:837-902). Returns (B, H, W, C) buffers flipped
    to image orientation, and the clip-space vertices.

    Albedo: the texture when verts_uv, faces_uv and tex are all given, else
    v_color, else white. Normals: interpolated vertex normals in the
    settings' lighting space (shade_smooth), or the winning face's normal in
    camera space. Shading: SH with `lights` when given, else the settings'
    lighting type. Every pixel samples the texture: no coverage mask.
    """
    rd = rasterize_mesh(verts, faces, RT, K, image_size, settings,
                        grad_enabled=False)
    rast, rast_db, tri_id = rd["rast"], rd["rast_db"], rd["tri_id"]
    fg_mask = (tri_id > 0)[..., None]
    use_kernels = settings.use_kernels

    if shade_smooth:
        space_verts = (verts if settings.lighting_space == "world"
                       else rd["verts_camera"])
        v_normal = compute_v_normals(space_verts, faces)
        normal, _ = interpolate(v_normal, rast, faces, use_kernels=use_kernels)
        normal = safe_normalize(normal)
    else:
        gather = plane_gather if use_kernels else plane_gather_plain
        fn = compute_face_normals(rd["verts_camera"], faces)     # (B, F, 3)
        normal = gather(fn.transpose(1, 2).contiguous(), tri_id).permute(0, 2, 3, 1)

    if verts_uv is not None and faces_uv is not None and tex is not None:
        verts_uv, faces_uv, short = _uv_tables_for(faces, verts_uv, faces_uv)
        texc, texd = interpolate(verts_uv[None], rast, faces_uv, rast_db=rast_db,
                                 diff_attrs="all", use_kernels=use_kernels)
        if short:
            no_uv = torch.isnan(texc[..., 0])
            m = no_uv[..., None]
            albedo = texture_sample(tex.permute(0, 2, 3, 1),
                                    torch.where(m, 0.0, texc),
                                    torch.where(m, 0.0, texd),
                                    mask=~no_uv, use_kernels=use_kernels)
            albedo = torch.where(no_uv[..., None], float("nan"), albedo)
        else:
            albedo = texture_sample(tex.permute(0, 2, 3, 1), texc, texd,
                                    use_kernels=use_kernels)
    elif v_color is not None:
        if v_color.dim() == 2:
            v_color = v_color[None]
        albedo, _ = interpolate(v_color, rast, faces, use_kernels=use_kernels)
    else:
        albedo = torch.ones_like(normal)

    lighting_type = "SH" if lights is not None else settings.lighting_type
    diffuse = shade(normal, lighting_type, lights)

    rgb = albedo * diffuse
    alpha = fg_mask.to(rgb.dtype)
    rgba = torch.cat([rgb, alpha], dim=-1)

    rgba_bg = constant(tuple(background_color) + (0.0,), rgba.dtype,
                       rgba.device).expand(rgba.shape)
    normal = torch.where(fg_mask, normal, rgba_bg[..., :3])
    diffuse_out = torch.where(fg_mask, diffuse, rgba_bg[..., :3])
    rgba = torch.where(fg_mask, rgba, rgba_bg)

    if settings.antialias:
        rgba_aa = antialias_rast(rgba, rast, rd["verts_clip"], faces,
                                 use_kernels=use_kernels)
    else:
        rgba_aa = rgba

    def flip(x):
        return torch.flip(x, dims=[1])

    return {
        "albedo": flip(albedo),
        "normal": flip(normal),
        "diffuse": flip(diffuse_out),
        "rgba": flip(rgba_aa),
        "verts_clip": rd["verts_clip"],
    }
