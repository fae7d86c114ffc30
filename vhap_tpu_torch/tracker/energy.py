"""Energy terms: landmark, photometric and regularization.

Counterpart of vhap_tpu/tracker/energy.py (reference:
vhap/model/tracker.py:141-157, 347-750). One energy function is built per
stage (`make_energy_fn`), closing over the static setup: the evaluation
energy (stage_name=None) is called as `energy(params, batch)`, a training
stage's as `energy(params, batch, generator)`, the generator feeding the
cluster disturbance.

Batch convention (channel-last):
  rgb (B, H, W, 3) in [0,1], already background-composited
  lmk2d (B, L, 3) pixel coords + confidence
  intrinsic (B, 4) or (B, 3, 3), extrinsic (B, 3|4, 4) world->camera
  timestep_index (B,) int
  weight (B,) float, 0 for padded samples

A training stage adds the stage gating of the optimizable groups, the
regularizers, the region texture and boundary masks and, for photometric
stages, the cluster disturbance.

Under a process group (parallel/sharding.py) each rank holds a contiguous
block of the batch's rows and its energy is built so that the ranks'
energies sum to the whole batch's: every normalizer that depends on the
batch (the weight sum, the photometric area, the unweighted row counts) is
global, all-reduced detached, since none carries a gradient; the
batch-free regularizers are added on rank 0 only; `reg_diffuse`'s max term
on the one rank that holds the batch's max. The summed gradient is then
the whole batch's, as in the JAX package's GSPMD program. The log terms
are the rank's shares (their sum over ranks is the batch's, the overflow
counter included, as JAX psums it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vhap_tpu_torch.config.base import BaseTrackingConfig, PhotometricStageConfig
from vhap_tpu_torch.device import constant, resolve_device
from vhap_tpu_torch.model.flame import (FlameHead, laplacian_apply,
                                        laplacian_blur_apply)
from vhap_tpu_torch.model.lbs import batch_rodrigues
from vhap_tpu_torch.ops import camera as cam
from vhap_tpu_torch.ops.render import RenderSettings, rasterize_mesh, render_rgba
from vhap_tpu_torch.ops.shading import uniform_sh_lights
from vhap_tpu_torch.parallel import sharding
from vhap_tpu_torch.tracker import params as P
from vhap_tpu_torch.util.profiling import span


def normalize_image_points(u, v, resolution):
    """[0, size] pixels -> [-1, 1] (vhap/util/mesh.py:41-51)."""
    h, w = resolution
    return 2 * (u - w / 2.0) / w, 2 * (v - h / 2.0) / h


def _wmean(x, w, w_sum=None, axis_batch=0):
    """Weighted mean over all elements with per-sample weights w (B,);
    `w_sum` is the batch's weight sum (default: w.sum(), this block's)."""
    bshape = [1] * x.dim()
    bshape[axis_batch] = -1
    wx = x * w.reshape(bshape)
    denom = (w.sum() if w_sum is None else w_sum) * (x.numel() / x.shape[axis_batch])
    return wx.sum() / torch.clamp(denom, min=1e-12)


def _batch_mean(x):
    """The unweighted mean of x over the whole batch (padded rows count,
    as in JAX): x.mean(), or under a process group this rank's sum over the
    batch's element count (every rank holds as many rows)."""
    if not sharding.is_distributed():
        return x.mean()
    return x.sum() / (x.numel() * sharding.world())


def fill_cam_params(batch: Dict, params: P.Params, calibrated: bool,
                    image_size) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intrinsics/extrinsics for the batch (vhap/model/tracker.py:141-157)."""
    if calibrated:
        return batch["intrinsic"], batch["extrinsic"]
    B = batch["rgb"].shape[0]
    h, w = image_size
    f = (params["focal_length"] * max(h, w)).expand(B)
    K = torch.stack([f, f, torch.full_like(f, 0.5 * w),
                     torch.full_like(f, 0.5 * h)], dim=1)
    RT = constant(((1.0, 0.0, 0.0, 0.0), (0.0, 1.0, 0.0, 0.0),
                   (0.0, 0.0, 1.0, -1.0)), f.dtype, f.device)
    return K, RT.expand(B, 3, 4)


def landmark_energy(batch, pred_lmks, K, RT, image_size,
                    disable_jawline: bool, always_jawline: bool, w_sum=None):
    """Confidence-weighted L1 landmark loss (vhap/model/tracker.py:347-389)."""
    h, w = image_size
    lmk2d = batch["lmk2d"]
    gt_xy = torch.stack(normalize_image_points(
        lmk2d[..., 0], lmk2d[..., 1], (h, w)), dim=-1)
    conf = lmk2d[..., 2]

    pred_ndc = cam.world_to_ndc(pred_lmks, RT, K, (h, w), flip_y=True)
    pred_xy = pred_ndc[..., :2]

    if not always_jawline and disable_jawline:
        diff = gt_xy[:, 17:68] - pred_xy[:, 17:68]
        conf = conf[:, 17:68]
    else:
        diff = gt_xy[:, :68] - pred_xy[:, :68]
        conf = conf[:, :68]
        # nose landmarks are robust -> 10x confidence (tracker.py:377-379)
        scale = torch.ones_like(conf)
        scale[:, 27:36] = 10.0
        conf = conf * scale

    loss = torch.sum(torch.abs(diff), dim=2) * conf          # (B, L)
    e = _wmean(loss, batch["weight"], w_sum)
    return e, {"gt_lmk2d": gt_xy, "pred_lmk2d": pred_xy,
               "lmk_per_sample": loss.mean(dim=1)}


def photometric_energy(batch, render_out):
    """|gt - pred| normalized by foreground area, image form
    (vhap/model/tracker.py:391-478)."""
    gt = batch["rgb"]                                     # (B, H, W, 3)
    pred = render_out["rgba"][..., :3]
    alpha = render_out["rgba"][..., 3:]
    gt = gt.to(pred.dtype)
    pred_mask = (alpha.detach() > 0).to(torch.float32)
    w = batch["weight"]                                   # (B,) 0/1 padding

    # one per-sample reduction serves the weighted total and the
    # per-timestep eval losses (tracker.py:1078-1117)
    s = torch.sum(torch.abs(gt - pred), dim=(1, 2, 3), dtype=torch.float32)
    area = pred_mask.sum(dim=(1, 2, 3)) * 3  # mask expanded to 3ch in ref
    denom = sharding.all_reduce_sum((area * w).sum())    # the batch's
    color_loss = (s * w).sum() / torch.clamp(denom, min=1.0)
    per = s / torch.clamp(area, min=1.0)
    aux = {"gt_rgb": gt, "pred_rgb": pred, "error_rgb": gt - pred,
           "pred_alpha": alpha, "photo_per_sample": per}
    return color_loss, aux


@dataclass(frozen=True)
class RegPrecomputed:
    """Static tensors for the regularizers (built once per config)."""
    offset_relax_w: Optional[torch.Tensor]        # (V, 1)
    offset_lap_relax_w: Optional[torch.Tensor]    # (V, 1)
    rigid_vids: Tuple[torch.Tensor, ...]          # per-region vertex ids
    tex_res_cluster_mask: Optional[torch.Tensor]  # (1, Hm, Wm)


def build_reg_precomputed(head: FlameHead, cfg: BaseTrackingConfig) -> RegPrecomputed:
    """(vhap_tpu/tracker/energy.py:186-215), on the head's device."""
    V = head.num_verts
    dev = head.v_template.device
    w_cfg = cfg.w

    def region_weights(regions, coef):
        w = np.ones((V, 1), np.float32)
        ids = head.masks.get_vid_by_region([r for r in regions if r in head.masks.v])
        w[ids] *= coef
        wt = torch.as_tensor(w, device=dev)[None]
        for _ in range(w_cfg.blur_iter):
            wt = laplacian_blur_apply(head.lap_nbr_idx, head.lap_nbr_w, wt)
        return wt[0]

    offset_relax_w = (region_weights(w_cfg.reg_offset_relax_for,
                                     w_cfg.reg_offset_relax_coef)
                      if len(w_cfg.reg_offset_relax_for) else None)
    offset_lap_relax_w = (region_weights(w_cfg.reg_offset_lap_relax_for,
                                         w_cfg.reg_offset_lap_relax_coef)
                          if len(w_cfg.reg_offset_lap_relax_for) else None)
    # a region needs >= 2 vertices for an unbiased variance (correction=1)
    rigid_vids = tuple(
        torch.as_tensor(vids, device=dev) for vids in (
            np.asarray(head.masks.get_vid_by_region([r]))
            for r in w_cfg.reg_offset_rigid_for if r in head.masks.v)
        if len(vids) >= 2)
    tex_mask = head.uv_masks.get_uvmask_by_region(w_cfg.reg_tex_res_for)
    tex_res_cluster_mask = (None if tex_mask is None else torch.as_tensor(
        tex_mask[None].astype(np.float32), device=dev))
    return RegPrecomputed(offset_relax_w, offset_lap_relax_w, rigid_vids,
                          tex_res_cluster_mask)


def regularization_energy(
    params: P.Params, batch, verts, verts_cano, albedo, render_out,
    head: FlameHead, cfg: BaseTrackingConfig, stage_name: str,
    opt: Dict[str, bool], pre: RegPrecomputed, n_timesteps: int,
    w_sum: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """All regularizers (vhap/model/tracker.py:480-690), stage-gated; the
    detaches are those of vhap_tpu/tracker/energy.py:218-339. `w_sum` is the
    batch's weight sum (default: this block's); under a process group the
    batch-free terms are rank 0's alone (0 elsewhere)."""
    w_cfg = cfg.w
    log = {}
    ts = batch["timestep_index"].long()
    ts_prev = torch.clamp(ts - 1, 0, n_timesteps - 1)
    bw = batch["weight"]
    if w_sum is None:
        w_sum = bw.sum()
    tracking = "tracking" in stage_name
    lead = sharding.rank() == 0

    def once(term_fn):
        """A batch-free term, counted once over the ranks: rank 0's."""
        return term_fn() if lead else torch.zeros((), device=bw.device)

    def smooth(cur, prev, weight):
        return _wmean((cur - prev.detach()) ** 2, bw, w_sum) * weight

    if opt["pose"] and tracking:
        log["smooth_pose"] = (
            smooth(params["translation"][ts], params["translation"][ts_prev],
                   w_cfg.smooth_trans)
            + smooth(params["rotation"][ts], params["rotation"][ts_prev],
                     w_cfg.smooth_rot))

    if opt["joints"]:
        log["reg_joint"] = _joint_l2(params, ts, bw, w_cfg, w_sum)
        if tracking:
            log["smooth_joint"] = (
                smooth(params["neck_pose"][ts], params["neck_pose"][ts_prev], w_cfg.smooth_neck)
                + smooth(params["jaw_pose"][ts], params["jaw_pose"][ts_prev], w_cfg.smooth_jaw)
                + smooth(params["eyes_pose"][ts], params["eyes_pose"][ts_prev], w_cfg.smooth_eyes))

    if opt["expr"]:
        log["reg_expr"] = w_cfg.reg_expr * _wmean(params["expr"][ts] ** 2, bw, w_sum)
        if tracking:
            log["smooth_expr"] = smooth(params["expr"][ts], params["expr"][ts_prev],
                                        w_cfg.smooth_expr)

    if opt["shape"]:
        log["reg_shape"] = once(
            lambda: w_cfg.reg_shape * torch.mean(params["shape"] ** 2))

    if opt["texture"]:
        if not cfg.model.tex_painted and "tex_pca" in params:
            log["reg_tex_pca"] = once(
                lambda: w_cfg.reg_tex_pca * torch.mean(params["tex_pca"] ** 2))
        if cfg.model.tex_extra and cfg.model.residual_tex and "tex_extra" in params:
            if w_cfg.reg_tex_tv is not None:
                def tex_tv():
                    # the reference sums the flattened y/x squared diffs
                    # element-wise before averaging (tracker.py:526-534)
                    tex = albedo[0]                      # (3, H, W)
                    tv_y = (tex[:, :-1, :] - tex[:, 1:, :]) ** 2
                    tv_x = (tex[:, :, :-1] - tex[:, :, 1:]) ** 2
                    tv = (tv_y.reshape(3, -1) + tv_x.reshape(3, -1)).mean()
                    w_tv = w_cfg.reg_tex_tv * cfg.data.scale_factor ** 2
                    if cfg.data.n_downsample_rgb is not None:
                        w_tv /= cfg.data.n_downsample_rgb ** 2
                    return w_tv * tv
                log["reg_tex_tv"] = once(tex_tv)
            if (w_cfg.reg_tex_res_clusters is not None
                    and pre.tex_res_cluster_mask is not None):
                def tex_res_clusters():
                    m = pre.tex_res_cluster_mask
                    if m.shape[-2:] != params["tex_extra"].shape[-2:]:
                        # jax.image.resize "nearest" samples at half-pixel
                        # centres: "nearest-exact", not "nearest"
                        m = F.interpolate(m[None], size=tuple(params["tex_extra"].shape[-2:]),
                                          mode="nearest-exact")[0]
                    return (w_cfg.reg_tex_res_clusters
                            * torch.mean(params["tex_extra"] ** 2 * m))
                log["reg_tex_res_clusters"] = once(tex_res_clusters)

    if opt["lights"] and "lights" in params:
        if w_cfg.reg_light is not None:
            sh0 = constant(uniform_sh_lights().tolist(), torch.float32,
                           params["lights"].device)
            log["reg_light"] = once(lambda: w_cfg.reg_light * torch.mean(
                (params["lights"] - sh0) ** 2))
        if w_cfg.reg_diffuse is not None and render_out is not None:
            d = render_out["diffuse_detach_normal"]      # (B, H, W, 3)
            over = torch.relu(d.max() - 1.0)
            if sharding.is_distributed():
                # the batch's max: its gradient reaches the one element that
                # holds it, so only the lowest rank holding it adds the term
                # (with its local max); no host sync
                m = sharding.all_gather_rows(d.max().detach().reshape(1), "max_rank")
                over = torch.where(torch.argmax(m) == sharding.rank(), over,
                                   torch.zeros_like(over))
            reg = over + _batch_mean(torch.var(d, dim=-1, correction=1))
            log["reg_diffuse"] = w_cfg.reg_diffuse * reg

    if opt["static_offset"] or opt["dynamic_offset"]:
        offset = None
        if "static_offset" in params:
            offset = params["static_offset"]
        if "dynamic_offset" in params:
            dyn = params["dynamic_offset"][ts]
            offset = dyn if offset is None else offset + dyn
        if offset is not None:
            offset = offset.expand(verts_cano.shape)
            if w_cfg.reg_offset_lap is not None:
                base = (verts_cano - offset).detach()
                lap_base = laplacian_apply(head.lap_nbr_idx, head.lap_nbr_w, base)
                lap_off = laplacian_apply(head.lap_nbr_idx, head.lap_nbr_w,
                                          base + offset)
                diff = ((lap_off - lap_base) ** 2).sum(-1, keepdim=True)
                if pre.offset_lap_relax_w is not None:
                    diff = diff * pre.offset_lap_relax_w[None]
                log["reg_offset_lap"] = w_cfg.reg_offset_lap * _wmean(diff, bw, w_sum)
            if w_cfg.reg_offset is not None:
                reg = torch.abs(offset)
                if pre.offset_relax_w is not None:
                    reg = reg * pre.offset_relax_w[None]
                log["reg_offset"] = w_cfg.reg_offset * _wmean(reg, bw, w_sum)
            if w_cfg.reg_offset_rigid is not None and pre.rigid_vids:
                rig = 0.0
                for vids in pre.rigid_vids:
                    rig = rig + _batch_mean(torch.var(offset[:, vids], dim=-2,
                                                      correction=1))
                log["reg_offset_rigid"] = w_cfg.reg_offset_rigid * rig
            if (w_cfg.reg_offset_dynamic is not None
                    and "dynamic_offset" in params and opt["dynamic_offset"]):
                d_prev = params["dynamic_offset"][ts_prev]
                d_cur = params["dynamic_offset"][ts]
                log["reg_offset_dynamic"] = (
                    w_cfg.reg_offset_dynamic * _wmean((d_cur - d_prev) ** 2, bw, w_sum))

    return log


def _joint_l2(params, ts, bw, w_cfg, w_sum):
    """Joint priors in rotation-matrix space (vhap/model/tracker.py:650-680).

    Replicates the reference's mean over a (2B-1)-row stack where B-1 rows
    are zero (identity-vs-identity), i.e. an effective B/(2B-1) scaling;
    B is the batch's weight sum `w_sum`.
    """
    poses = [
        ("neck", params["neck_pose"][ts], w_cfg.reg_neck),
        ("jaw", params["jaw_pose"][ts], w_cfg.reg_jaw),
        ("eyes", params["eyes_pose"][ts, :3], w_cfg.reg_eyes),
        ("eyes", params["eyes_pose"][ts, 3:], w_cfg.reg_eyes),
    ]
    sum_w = torch.clamp(w_sum, min=1.0)
    E = 0.0
    for name, pose, weight in poses:
        R = batch_rodrigues(pose)                           # (B, 3, 3)
        eye = torch.eye(3, dtype=R.dtype, device=R.device)
        sq = ((eye - R) ** 2).sum(dim=(1, 2)) / 9.0         # per-sample mean
        diff = (sq * bw).sum() / (2 * sum_w - 1)
        if name == "jaw":
            diff = diff + _wmean(torch.relu(-pose[:, 0]), bw, w_sum) * 10
            diff = diff + _wmean(pose[:, 1:] ** 2, bw, w_sum) * 3
        elif name == "eyes":
            diff = diff + _wmean((params["eyes_pose"][ts, :3]
                                  - params["eyes_pose"][ts, 3:]) ** 2, bw, w_sum)
        E = E + diff * weight
    return E


def make_albedo_fn(cfg: BaseTrackingConfig, tex_painted_model, tex_pca_model):
    """Albedo assembly (vhap/model/tracker.py:237-258)."""
    def get_albedo(params: P.Params) -> torch.Tensor:
        if cfg.model.tex_extra and not cfg.model.residual_tex:
            base = params["tex_extra"][None]
        elif cfg.model.tex_painted:
            base = tex_painted_model()
        else:
            base = tex_pca_model(params["tex_pca"][None])
        if cfg.model.tex_extra and cfg.model.residual_tex:
            res = params["tex_extra"][None]
            if base.shape[-2:] != res.shape[-2:]:
                # jax.image.resize's bilinear (see FlameTexPainted)
                base = F.interpolate(base, size=tuple(res.shape[-2:]),
                                     mode="bilinear", align_corners=False,
                                     antialias=True)
            return base + res
        return base
    return get_albedo


def render_verts_uv(head: FlameHead, device) -> torch.Tensor:
    """The render's (Vt, 2) uv table: v flipped (vhap/model/tracker.py:315-316)."""
    uv = np.asarray(head.assets.verts_uvs)
    return torch.as_tensor(np.stack([uv[:, 0], 1.0 - uv[:, 1]], -1),
                           dtype=torch.float32, device=device)


def make_energy_fn(
    head: FlameHead,
    cfg: BaseTrackingConfig,
    get_albedo: Callable,
    image_size: Tuple[int, int],
    n_timesteps: int,
    stage_name: Optional[str] = None,
    with_aux: bool = True,
    device=None,
    use_kernels: bool = True,
) -> Callable:
    """Build one stage's energy, as vhap_tpu's make_energy_fn
    (vhap_tpu/tracker/energy.py:398-565), with the same log and aux keys.

    stage_name=None: the evaluation energy, `energy(params, batch) ->
    (E_total, (log, aux))`. A stage of cfg.pipeline: that stage's training
    energy, `energy(params, batch, generator)`, with its landmark gating,
    photometric term on `background_train`, region texture and boundary
    masks, the cluster disturbance (photometric stages; random numbers from
    `generator`, a torch.Generator on the energy's device) and the
    regularizers of its optimizable groups. It computes on `device`
    (default: the CUDA card), where `head` must live. use_kernels=False
    runs the plain PyTorch version of every kernel instead (the reference
    for the kernels on the card).
    """
    dev = resolve_device(device)
    if head.v_template.device.type != dev.type:
        raise ValueError(f"head lives on {head.v_template.device}, "
                         f"the energy computes on {dev}")
    cfg.render.check_portable()
    calibrated = cfg.data.calibrated
    settings = RenderSettings(
        lighting_type=cfg.render.lighting_type,
        lighting_space=cfg.render.lighting_space,
        disturb_rate_fg=cfg.render.disturb_rate_fg,
        disturb_rate_bg=cfg.render.disturb_rate_bg,
        disturb_pool_stride=cfg.render.disturb_pool_stride,
        disturb_impl=cfg.render.disturb_impl,
        antialias=cfg.render.antialias,
        use_kernels=use_kernels)

    if stage_name is not None:
        stage_cfg = cfg.pipeline[stage_name]
        is_photo_stage = isinstance(stage_cfg, PhotometricStageConfig)
        opt = {k: False for k in ("cam", "pose", "shape", "joints", "expr",
                                  "texture", "lights", "static_offset",
                                  "dynamic_offset")}
        for p in stage_cfg.optimizable_params:
            opt[p] = True
        disable_jawline = stage_cfg.disable_jawline_landmarks
        background = cfg.render.background_train
        if is_photo_stage:
            tex_mask = torch.as_tensor(
                head.masks.face_mask_padded(stage_cfg.align_texture_except),
                device=dev)
            bnd_mask = torch.as_tensor(
                head.masks.vertex_mask(stage_cfg.align_boundary_except),
                device=dev)
        else:
            tex_mask = bnd_mask = None
    else:
        is_photo_stage = True
        opt = None
        disable_jawline = False
        background = cfg.render.background_eval
        tex_mask = bnd_mask = None

    enable_photo = cfg.w.photo is not None and is_photo_stage
    enable_disturbance = stage_name is not None and is_photo_stage
    pre = build_reg_precomputed(head, cfg) if stage_name is not None else None

    verts_uv = render_verts_uv(head, dev)
    fid2cid = torch.as_tensor(head.masks.fid2cid, device=dev)
    num_clusters = head.masks.num_clusters

    def energy(params: P.Params, batch: Dict,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, Tuple]:
        log: Dict[str, torch.Tensor] = {}
        aux: Dict[str, torch.Tensor] = {"gt_rgb": batch["rgb"]} if "rgb" in batch else {}
        ts = batch["timestep_index"]
        w_sum = sharding.all_reduce_sum(batch["weight"].sum())   # the batch's

        sliced = P.slice_batch(params, ts)
        B = ts.shape[0]
        with span("flame"):
            verts, verts_cano, lmks = head(
                shape=params["shape"][None].expand(B, -1),
                expr=sliced["expr"],
                rotation=sliced["rotation"],
                neck=sliced["neck_pose"],
                jaw=sliced["jaw_pose"],
                eyes=sliced["eyes_pose"],
                translation=sliced["translation"],
                return_verts_cano=True,
                static_offset=params.get("static_offset"),
                dynamic_offset=sliced.get("dynamic_offset"),
            )
            albedo = get_albedo(params)

        K, RT = fill_cam_params(batch, params, calibrated, image_size)

        if cfg.w.landmark is not None:
            e_lmk, lmk_aux = landmark_energy(
                batch, lmks, K, RT, image_size, disable_jawline,
                cfg.w.always_enable_jawline_landmarks, w_sum)
            log["lmk"] = cfg.w.landmark * e_lmk
            aux.update(lmk_aux)

        render_out = None
        if enable_photo:
            if background == "target":
                bg = batch["rgb"]  # top-down; renderer flips to buffer space
            elif background == "white":
                bg = (1.0, 1.0, 1.0)
            else:
                bg = (0.0, 0.0, 0.0)
            with span("render"):
                rast_dict = rasterize_mesh(verts, head.faces, RT, K, image_size,
                                           settings, with_attrs=False)
                render_out = render_rgba(
                    rast_dict, head.faces, verts_uv, head.textures_idx, albedo,
                    params["lights"][None] if "lights" in params else None,
                    settings, bg, tex_mask, bnd_mask,
                    enable_disturbance=enable_disturbance, fid2cid=fid2cid,
                    num_clusters=num_clusters, generator=generator,
                    sample_weight=batch["weight"])
            e_photo, photo_aux = photometric_energy(batch, render_out)
            log["photo"] = cfg.w.photo * e_photo
            aux.update(photo_aux)
            if with_aux:
                aux.update(render_out)

        if stage_name is not None:
            log.update(regularization_energy(
                params, batch, verts, verts_cano, albedo, render_out,
                head, cfg, stage_name, opt, pre, n_timesteps, w_sum))

        E_total = torch.sum(torch.stack(list(log.values())))
        log["total"] = E_total
        if enable_photo:
            # monitor only (after the total): the port rasterizes exactly,
            # with no bin budget, so this stays 0 (host ints; a fill, no copy)
            log["rast_overflow"] = torch.full(
                (), float(rast_dict["overflow"] + render_out["plane_overflow"]),
                device=dev)
        if with_aux:
            aux.update({"verts": verts, "lmks": lmks, "albedo_map": albedo})
        return E_total, (log, aux)

    if stage_name is None:
        def eval_energy(params: P.Params, batch: Dict) -> Tuple[torch.Tensor, Tuple]:
            return energy(params, batch)
        return eval_energy
    return energy
