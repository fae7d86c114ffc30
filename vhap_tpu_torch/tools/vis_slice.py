"""The visualization render at the bench's full width.

`render_rgba_vis` (the nvdiffrast-style path: `rasterize`, `interpolate`,
mip texture, SH shading, antialias) on the evaluation slice's scene
(tools/eval_slice.py): its head, parameters, cameras, SH lights and 2048
albedo (painted texture + residual), batch 16 at 512x512 by default.
`grad_loss` is the same chain differentiated, as nvdiffrast's users write
it: rasterize(grad_enabled=True) -> interpolate(uv, rast_db,
diff_attrs='all') -> texture_sample -> shade -> antialias_rast, summed
against a cotangent. Used by chip_smoke.py and tools/profile_eval.py; the
tests build it at a tiny size on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from vhap_tpu_torch.ops import camera as cam
from vhap_tpu_torch.ops.antialias import antialias_rast
from vhap_tpu_torch.ops.rasterize import interpolate, rasterize
from vhap_tpu_torch.ops.render import RenderSettings, render_rgba_vis
from vhap_tpu_torch.ops.shading import compute_v_normals, safe_normalize, shade
from vhap_tpu_torch.ops.texture import texture_sample
from vhap_tpu_torch.tools.eval_slice import EvalSlice, build_eval_slice
from vhap_tpu_torch.tracker import params as P
from vhap_tpu_torch.tracker.energy import fill_cam_params, render_verts_uv


@dataclass
class VisSlice:
    eval: EvalSlice
    verts: torch.Tensor          # (B, V, 3) world vertices
    RT: torch.Tensor             # (B, 3, 4)
    K: torch.Tensor              # (B, 4)
    verts_uv: torch.Tensor       # (Vt, 2), v flipped
    tex: torch.Tensor            # (1, 3, T, T) albedo
    lights: torch.Tensor         # (1, 9, 3)

    @property
    def image_size(self) -> Tuple[int, int]:
        return self.eval.image_size

    def render(self, use_kernels: bool = True, **kwargs) -> Dict[str, torch.Tensor]:
        """render_rgba_vis of the slice; kwargs override its inputs
        (shade_smooth, v_color, tex=None, lights=None, background_color)
        or, as `settings`, the render settings."""
        head = self.eval.head
        settings = kwargs.pop("settings", RenderSettings(use_kernels=use_kernels))
        inputs = dict(verts_uv=self.verts_uv, faces_uv=head.textures_idx,
                      tex=self.tex, lights=self.lights)
        inputs.update(kwargs)
        with torch.no_grad():
            return render_rgba_vis(self.verts, head.faces, self.RT, self.K,
                                   self.image_size, settings, **inputs)

    def grad_loss(self, verts: torch.Tensor, tex: torch.Tensor,
                  cotangent: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        """sum(antialiased rgba * cotangent) through the differentiable
        chain; cotangent (B, H, W, 4) in buffer orientation."""
        head, size = self.eval.head, self.image_size
        clip = cam.camera_to_clip(cam.world_to_camera(verts, self.RT), self.K, size)
        rast, rast_db, tri_id = rasterize(clip, head.faces, size, grad_enabled=True,
                                          use_kernels=use_kernels)
        texc, texd = interpolate(self.verts_uv[None], rast, head.textures_idx,
                                 rast_db=rast_db, diff_attrs="all",
                                 use_kernels=use_kernels)
        albedo = texture_sample(tex.permute(0, 2, 3, 1), texc, texd,
                                use_kernels=use_kernels)
        normal, _ = interpolate(compute_v_normals(verts, head.faces), rast,
                                head.faces, use_kernels=use_kernels)
        rgb = albedo * shade(safe_normalize(normal), "SH", self.lights)
        fg = (tri_id > 0)[..., None]
        rgba = torch.cat([torch.where(fg, rgb, torch.ones_like(rgb)),
                          fg.to(rgb.dtype)], dim=-1)
        out = antialias_rast(rgba, rast, clip, head.faces, use_kernels=use_kernels)
        return torch.sum(out * cotangent)


def build_vis_slice(device=None, batch_size: int = 16,
                    image_size: Tuple[int, int] = (512, 512),
                    tex_res: int = 2048, n_shape: int = 300,
                    n_expr: int = 100, seed: int = 0) -> VisSlice:
    return vis_slice_from_eval(build_eval_slice(
        device=device, batch_size=batch_size, image_size=image_size,
        tex_res=tex_res, n_shape=n_shape, n_expr=n_expr, seed=seed))


def vis_slice_from_eval(s: EvalSlice) -> VisSlice:
    """The vis slice of an evaluation slice's scene, at its parameters."""
    params, batch, head, image_size = s.params, s.batch, s.head, s.image_size
    dev = params["shape"].device
    with torch.no_grad():
        sl = P.slice_batch(params, batch["timestep_index"])
        B = batch["timestep_index"].shape[0]
        verts = head(shape=params["shape"][None].expand(B, -1), expr=sl["expr"],
                     rotation=sl["rotation"], neck=sl["neck_pose"],
                     jaw=sl["jaw_pose"], eyes=sl["eyes_pose"],
                     translation=sl["translation"], return_landmarks=False,
                     static_offset=params.get("static_offset"))
        K, RT = fill_cam_params(batch, params, False, image_size)
        tex = s.get_albedo(params)
    return VisSlice(s, verts, RT.contiguous(), K, render_verts_uv(head, dev),
                    tex, params["lights"][None])
