"""Render pipelines, in image layout.

Counterpart of vhap_tpu/ops/render.py's path of the tracker's energies
(`rasterize_mesh` + `render_rgba`, reference:
vhap/util/render_nvdiffrast.py:216-245, 354-484), every step plain:
visibility -> vertex normals -> one packed face table -> fused
interpolation -> mip-mapped texture -> SH shading -> background
compositing -> cluster disturbance -> antialias. The training step adds
three features of the same function: the region texture-gradient detach
(a flag row of the face table), the boundary-detached antialias planes,
and the cluster disturbance (the adaptive appearance prior,
`impl='sample'`; its cluster ids ride the face table as a second flag
row).

The color chain is float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from reference.ops import camera as cam
from reference.ops.antialias import AA_PLANE_KEYS, antialias
from reference.ops.interp import fused_interp_plain, split_channels
from reference.ops.rasterize import (PLANE_KEYS, face_attribute_planes,
                                     visibility_plain)
from reference.ops.shading import compute_v_normals, shade
from reference.ops.texture import texture_sample
from reference.parallel import sharding


@dataclass(frozen=True)
class RenderSettings:
    """The fields of vhap_tpu's RenderSettings that the port reads.

    disturb_impl 'auto' and 'sample' run the sampling
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


def rasterize_mesh(verts, faces, RT, K, image_size,
                   settings: RenderSettings) -> Dict:
    """World-space mesh -> fragment buffers up to visibility
    (vhap/util/render_nvdiffrast.py:216-245): render_rgba's fused pass
    computes the per-pixel attributes itself."""
    verts_camera = cam.world_to_camera(verts, RT)
    verts_clip = cam.camera_to_clip(verts_camera, K, image_size)
    H, W = image_size
    tri_id, overflow = visibility_plain(verts_clip.detach(), faces, H, W,
                                        settings.cull_backfaces)
    return dict(verts=verts, verts_camera=verts_camera[..., :3],
                verts_clip=verts_clip, tri_id=tri_id, overflow=overflow)


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
    if isinstance(generator, (list, tuple)):
        return _sharded_disturbance(rgba, rgba_bg, cid, generator, rate_fg,
                                    rate_bg, num_clusters, pool_stride,
                                    sample_weight)
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
    keys = sharding.all_gather_rows(keys)     # the whole batch's pool
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


def _pool_keys(rgba, rgba_bg, cid, num_clusters, pool_stride, sample_weight):
    """One process's subsampled pool keys, as _cluster_disturbance forms
    them before the gather."""
    B, H, W, _ = rgba.shape
    N = B * H * W
    rgb = rgba[..., :3].reshape(N, 3)
    cid = cid.reshape(N)
    pool_cid = cid
    if sample_weight is not None:
        valid = (sample_weight > 0)[:, None, None].expand(B, H, W).reshape(N)
        pool_cid = torch.where(valid, cid, torch.full_like(cid, num_clusters))
    mixed = torch.where((cid == 0)[:, None], rgba_bg[..., :3].reshape(N, 3),
                        rgb).detach()
    keys = _pack_cid_rgb_u8(pool_cid, mixed)
    if pool_stride > 1:
        g = N // (128 * pool_stride)
        keys = keys[:g * 128 * pool_stride].reshape(
            g, pool_stride, 128)[:, 0].reshape(-1)
    return keys


def _sharded_disturbance(rgba, rgba_bg, cid, generators, rate_fg, rate_bg,
                         num_clusters, pool_stride, sample_weight):
    """The disturbance of a batch sharded over len(generators) processes
    (parallel/sharding.py's contiguous row blocks), worked out in one: each
    block's subsampled keys joined in rank order into one pool, then each
    block's pixels drawn with that rank's generator."""
    n = len(generators)
    B = rgba.shape[0]
    if B % n:
        raise ValueError(f"{B} rows do not split over {n} processes")
    rgba_bg = rgba_bg.expand(rgba.shape)
    blocks = [slice(r * B // n, (r + 1) * B // n) for r in range(n)]
    sw = [None if sample_weight is None else sample_weight[b] for b in blocks]
    keys = torch.cat([_pool_keys(rgba[b], rgba_bg[b], cid[b], num_clusters,
                                 pool_stride, w) for b, w in zip(blocks, sw)])
    if keys.numel() == 0:
        return rgba
    sorted_keys = torch.sort(keys).values
    bounds = torch.arange(num_clusters + 1, dtype=torch.int32,
                          device=rgba.device) << 24
    edges = torch.searchsorted(sorted_keys, bounds, right=False)
    offsets, counts = edges[:-1], edges[1:] - edges[:-1]
    outs = []
    for b, gen in zip(blocks, generators):
        Bb, H, W, _ = rgba[b].shape
        N = Bb * H * W
        rgb = rgba[b][..., :3].reshape(N, 3)
        c = cid[b].reshape(N)
        cid_l = c.long()
        cnt = counts[cid_l]
        w_bool = _disturbance_swap_mask(gen, c, rate_fg, rate_bg) & (cnt > 0)
        r = torch.randint(0, 2**31 - 1, (N,), generator=gen,
                          device=rgba.device) % torch.clamp(cnt, min=1)
        idx = torch.where(w_bool, offsets[cid_l] + r, torch.zeros_like(r))
        src = _unpack_rgb_u8(sorted_keys[idx], dtype=rgb.dtype)
        w = w_bool.to(rgb.dtype)[:, None]
        out = src * w + rgb * (1.0 - w)
        outs.append(torch.cat([out.reshape(Bb, H, W, 3), rgba[b][..., 3:]], dim=-1))
    return torch.cat(outs)


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

    packed, n_flags = face_tables(
        rast_dict, faces, verts_uv, faces_uv, settings,
        align_texture_face_mask, align_boundary_vert_mask,
        fid2cid if enable_disturbance else None)
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
    albedo = texture_sample(tex.permute(0, 2, 3, 1), texc, texd,
                            mask=fg_mask[..., 0])

    diffuse = shade(normal, settings.lighting_type, lights)
    diffuse_detach_normal = shade(normal.detach(), settings.lighting_type, lights)

    rgb = albedo * diffuse
    alpha = fg_mask.to(rgb.dtype)
    rgba = torch.cat([rgb, alpha], dim=-1)

    # ---- background (render_nvdiffrast.py:409-421) ----
    if isinstance(background_color, (list, tuple)):
        rgba_bg = torch.tensor(list(background_color) + [0.0], dtype=rgba.dtype,
                               device=rgba.device).expand(rgba.shape)
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
        rgba = _cluster_disturbance(
            rgba, rgba_bg, cid, generator, settings.disturb_rate_fg,
            settings.disturb_rate_bg, num_clusters,
            settings.disturb_pool_stride, sample_weight=sample_weight,
            impl="pairswap" if settings.disturb_impl == "pairswap"
            else "sample")

    # ---- antialias (render_nvdiffrast.py:463-466; boundary-detach is in
    # the AA planes of the face table already) ----
    if settings.antialias:
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
