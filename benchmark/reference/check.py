"""The plain reference's first steps of a cell, and the comparison that
decides `correct`.

`follow` builds everything the tracker built, again and from the files the
benchmark wrote: the head (the reference's copy of the asset loader and
mesh surgery), the albedo, the initial parameters, the batches, the stage's
energy in plain PyTorch (the plain version of every kernel) and
leaf-lr Adam. It runs the cell's first steps with the disturbance's
generator seeded as the harness seeded the tracker's, and returns, per
step, the energy; per optimized leaf, the norm of step 1's gradient, of
the parameters' change made by step 1 and of their change over the steps;
and the counts of the first step's live work (costs.py prices them).

`compare` holds the program's readings against the reference's, in eight
numbers; a cell's `limits` name the ones it is judged on:
  loss        the largest gap of a step's energy, relative to the reference's;
  loss_first  the same for the first step alone, before Adam has moved
              anything (the later steps inherit every difference of the
              first update, and the cluster disturbance turns differences
              in the last bit of a rendered colour into other samples);
  grad        the worst leaf's gap between the two norms of step 1's
              gradient, relative to the larger of that leaf's and the
              median leaf's reference norm; grad_median the median leaf's;
  change      the same for the change over the steps, on the leaves whose
              reference gradient is at least a thousandth of the median
              leaf's (a leaf the energy reaches only through round-off moves
              under Adam by round-off alone); change_median the median
              leaf's;
  change_first, change_first_median
              the same for the change made by step 1 alone (its update
              follows step 1's gradient, before the disturbance's sorted
              samples of the later steps can amplify a last-bit difference).
"""

from __future__ import annotations

import contextlib
import statistics
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from reference import data as ref_data
from reference.config.base import BaseTrackingConfig
from reference.config.nersemble import NersembleTrackingConfig
from reference.model.flame import FlameHead, FlameTexPainted, FlameTexPCA
from reference.ops import render as ref_render
from reference.ops import rasterize as ref_rasterize
from reference.ops.texture import build_mip_pyramid
from reference.ops.texture_fetch import trilinear_taps
from reference.tracker import params as P
from reference.tracker.energy import make_albedo_fn, make_energy_fn
from reference.tracker.optim import (BETA1, leaf_learning_rates, make_train_step,
                                     stage_optimizable_leaves)

CLASSES = {"base": BaseTrackingConfig, "nersemble": NersembleTrackingConfig}
STEPS = 3


@contextlib.contextmanager
def _tf32(on: bool):
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@contextlib.contextmanager
def _record_render(rec: Dict):
    """Keep the first step's visibility inputs and texture-sample inputs."""
    vis, tex = ref_render.visibility_plain, ref_render.texture_sample

    def vis_rec(verts_clip, faces, H, W, cull=True):
        out = vis(verts_clip, faces, H, W, cull)
        rec.setdefault("vis", (verts_clip.detach(), faces, H, W, cull, out[0]))
        return out

    def tex_rec(tex_, uv, uv_da=None, mask=None, **kw):
        rec.setdefault("tex", (tex_.detach(), uv.detach(), uv_da.detach(), mask))
        return tex(tex_, uv, uv_da, mask, **kw)

    ref_render.visibility_plain, ref_render.texture_sample = vis_rec, tex_rec
    try:
        yield
    finally:
        ref_render.visibility_plain, ref_render.texture_sample = vis, tex


def load_batch(cfg, step_rows: Sequence[int], device) -> Dict[str, torch.Tensor]:
    d = cfg.data
    if d.calibrated:
        (t,) = step_rows
        return ref_data.rig_batch(d.root_folder, d.subject, d.sequence, t,
                                  tuple(d.image_size_during_calibration),
                                  d.n_downsample_rgb, d.use_color_correction,
                                  device, d.align_cameras_to_axes)
    seq = next(p for p in Path(d.root_folder).glob(f"{d.sequence}*") if p.is_dir())
    return ref_data.monocular_batch(seq, list(step_rows),
                                    d.background_color == "white", device)


def follow(cfg, stage: str, lr_scale: float, rows: List[Sequence[int]],
           n_timesteps: int, gen_seed: int, device, tf32: bool = False,
           counts: bool = True, fault: Optional[str] = None,
           count_rows: Optional[int] = None) -> Dict:
    """The reference's first len(rows) steps: rows[i] are step i's frame
    indices (a rig: its timestep). tf32=True computes its float32 matrix
    products in TF32 and `fault` plants one of FAULTS: the controls that
    the comparison must fail. The live counts are of the first
    `count_rows` rows (all by default): rank 0's block of a sharded batch,
    which is what rank 0's kernels and step do."""
    dev = torch.device(device)
    m = cfg.model
    head = FlameHead.build(n_shape=m.n_shape, n_expr=m.n_expr, asset_dir=m.asset_dir,
                           add_teeth=m.add_teeth, remove_lip_inside=m.remove_lip_inside,
                           face_clusters=m.tex_clusters, device=dev)
    a = head.assets
    tex_painted = (FlameTexPainted(a.tex_painted, m.tex_resolution, device=dev)
                   if a.tex_painted is not None else None)
    tex_pca = (FlameTexPCA(a.tex_mean, a.tex_basis, m.n_tex, m.tex_resolution, device=dev)
               if a.tex_mean is not None else None)
    get_albedo = make_albedo_fn(cfg, tex_painted, tex_pca)
    batches = [load_batch(cfg, r, dev) for r in rows]
    image_size = tuple(batches[0]["rgb"].shape[1:3])
    params = P.init_params(
        n_timesteps=n_timesteps, n_shape=m.n_shape, n_expr=m.n_expr, n_tex=m.n_tex,
        num_verts=head.num_verts, tex_resolution=m.tex_resolution,
        tex_painted=m.tex_painted, tex_extra=m.tex_extra,
        lighting_sh=cfg.render.lighting_type == "SH",
        use_static_offset=m.use_static_offset, use_dynamic_offset=m.use_dynamic_offset,
        calibrated=cfg.data.calibrated, device=dev)
    energy = make_energy_fn(head, cfg, get_albedo, image_size, n_timesteps, stage,
                            with_aux=False, device=dev)
    opt_leaves = stage_optimizable_leaves(cfg, stage, params)
    init_fn, step_fn = make_train_step(energy, opt_leaves, leaf_learning_rates(cfg),
                                       lr_scale)
    # a list of seeds: a batch sharded over that many processes, each
    # drawing its rows' disturbance from its own generator
    gen = ([torch.Generator(device=dev).manual_seed(g) for g in gen_seed]
           if isinstance(gen_seed, (list, tuple))
           else torch.Generator(device=dev).manual_seed(gen_seed))
    if fault is not None:
        step_fn = FAULTS[fault](step_fn)
    state = init_fn(params)
    p0 = {k: params[k].detach().clone() for k in opt_leaves}
    E, grad, first, rec = [], {}, {}, {}
    with _tf32(tf32):
        for i, b in enumerate(batches):
            ctx = _record_render(rec) if (counts and i == 0) else contextlib.nullcontext()
            with ctx:
                params, state, e, _ = step_fn(params, state, b, gen, 1.0)
            E.append(float(e))
            if i == 0:
                grad = {k: norm(state["mu"][k] / (1 - BETA1)) for k in opt_leaves}
                first = {k: norm(params[k] - p0[k]) for k in opt_leaves}
    change = {k: norm(params[k] - p0[k]) for k in opt_leaves}
    out = {"E": E, "grad": grad, "change_first": first, "change": change}
    if counts:
        out["counts"] = live_counts(rec, cfg, count_rows)
        out["counts"].update(V=int(head.num_verts), n_basis=m.n_shape + m.n_expr,
                             leaf_numel={k: int(p0[k].numel()) for k in p0})
    del params, state, batches, rec
    return out


def unchanged(step):
    """A step that returns its parameters and Adam state unchanged."""
    def faulty(params, state, batch, gen, lr_factor=1.0):
        out = step(params, state, batch, gen, lr_factor)
        return (params, state) + tuple(out[2:])
    return faulty


def half_batch(step):
    """A step on the first half of the batch, the mean taken over it."""
    def faulty(params, state, batch, gen, lr_factor=1.0):
        n = batch["weight"].shape[0] // 2
        return step(params, state, {k: v[:n] for k, v in batch.items()}, gen,
                    lr_factor)
    return faulty


def altered(step):
    """A step whose parameter update comes out 10 % too long."""
    def faulty(params, state, batch, gen, lr_factor=1.0):
        new, state2, *rest = step(params, state, batch, gen, lr_factor)
        with torch.no_grad():
            new = {k: (v + 0.1 * (v - params[k]) if v is not params[k] else v)
                   for k, v in new.items()}
        return (new, state2, *rest)
    return faulty


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.detach().to(torch.float64)))


def live_counts(rec: Dict, cfg, n_rows: Optional[int] = None) -> Dict:
    """The first step's live work of its first n_rows rows, as the kernel
    bounds count it: the visibility's valid faces and candidate pixels, the
    foreground and its visible faces, the texture's covered pixels, live
    taps and texels."""
    verts_clip, faces, H, W, cull, tri_id = rec["vis"]
    tex, uv, uv_da, mask = rec["tex"]
    n = n_rows or tri_id.shape[0]
    verts_clip, tri_id, uv, uv_da, mask = (x[:n] for x in (verts_clip, tri_id, uv,
                                                           uv_da, mask))
    B = int(tri_id.shape[0])
    setup = ref_rasterize.face_setup(verts_clip, faces, cull)
    span = (setup["bbox"] + 1.0) / torch.tensor(
        [2.0 / W, 2.0 / H, 2.0 / W, 2.0 / H], device=verts_clip.device) - 0.5
    nw = (torch.clamp(torch.ceil(span[..., 2]) + 1, max=W - 1)
          - torch.clamp(torch.floor(span[..., 0]) - 1, min=0) + 1).clamp(min=0)
    nh = (torch.clamp(torch.ceil(span[..., 3]) + 1, max=H - 1)
          - torch.clamp(torch.floor(span[..., 1]) - 1, min=0) + 1).clamp(min=0)
    fg = tri_id > 0
    flat, offsets, sizes = build_mip_pyramid(tex)
    idx, wgt = trilinear_taps(tex.shape[1:3], offsets, sizes, uv, uv_da, mask)
    live_tap = wgt != 0
    live_px = mask.reshape(B, -1)
    return {
        "B": B, "H": int(H), "W": int(W), "F": int(faces.shape[0]),
        "n_valid": int(setup["valid"].sum()),
        "n_cand": float((nw * nh * setup["valid"]).sum()),
        "n_fg": int(fg.sum()),
        "n_faces_visible": int(torch.unique(tri_id[fg]).numel()),
        "n_cov": int(mask.sum()),
        "n_taps": int(live_tap.sum()),
        "n_texels": int(torch.unique(idx[live_tap]).numel()),
        "n_texels_k4": int(torch.unique(idx[live_px[:, None].expand_as(idx)]).numel()),
        "n_texels_pyramid": int(flat.shape[1]),
        "tex_res": int(cfg.model.tex_resolution),
    }


def _gaps(prog: Dict, ref: Dict, keys) -> List[float]:
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The eight numbers `correct` may compare (see the module's docstring)."""
    e = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["E"], ref["E"])]
    g_ref = ref["grad"]
    g_med = statistics.median(g_ref.values())
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    grad = _gaps(prog["grad"], g_ref, list(g_ref))
    change = _gaps(prog["change"], ref["change"], moved)
    first = _gaps(prog["change_first"], ref["change_first"], moved)
    return {"loss": max(e), "loss_first": e[0],
            "grad": max(grad), "grad_median": statistics.median(grad),
            "change": max(change), "change_median": statistics.median(change),
            "change_first": max(first), "change_first_median": statistics.median(first)}
