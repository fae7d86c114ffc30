"""FLAME sequence viewer (vhap/flame_viewer.py equivalent).

Counterpart of vhap_tpu/flame_viewer.py. Renders a tracked
``tracked_flame_params*.npz`` sequence with the port's visualization render
(`render_rgba_vis`: K5 visibility, K6 plane gathers, K3 trilinear sampler on
the card). Two modes:

  * headless (default): renders every timestep from an orbitable camera to
    PNG frames and assembles an mp4 with ffmpeg when asked and ffmpeg is
    installed; works on any machine without a display;
  * interactive (``--interactive``): dearpygui orbit-camera playback with a
    timestep slider, matching the reference GUI; raises a clear error when
    dearpygui is not installed.

The head is the teeth head by default; on the asset loader's stand-in (no
FLAME template) pass the regions of tools/surgery_regions.write_region_assets
with --asset_dir (alias --model.asset_dir).

Usage:
    python -m vhap_tpu_torch.flame_viewer --param_path tracked_flame_params_30.npz \\
        --out_dir /tmp/viewer [--video] [--interactive] [--device cpu]
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from vhap_tpu_torch.device import resolve_device
from vhap_tpu_torch.model.flame import FlameHead, FlameTexPainted
from vhap_tpu_torch.ops.render import RenderSettings, render_rgba_vis
from vhap_tpu_torch.tracker.energy import render_verts_uv
from vhap_tpu_torch.util.camera_np import OrbitCamera
from vhap_tpu_torch.util.log import get_logger

logger = get_logger(__name__)


def require_dearpygui(fallback: str):
    """dearpygui's module, or a RuntimeError naming the headless mode."""
    try:
        import dearpygui.dearpygui as dpg
    except ImportError as e:
        raise RuntimeError(f"interactive mode requires dearpygui; use {fallback} "
                           "instead") from e
    return dpg


def composite_on_white(rgba: torch.Tensor) -> np.ndarray:
    """(H, W, 4) render -> (H, W, 3) uint8 over a white background."""
    rgba = rgba.cpu().numpy()
    rgb = np.clip(rgba[..., :3] * rgba[..., 3:] + (1 - rgba[..., 3:]), 0, 1)
    return (rgb * 255).astype(np.uint8)


class FlameViewer:
    def __init__(self, param_path: Path, n_shape=300, n_expr=100,
                 add_teeth=True, asset_dir=None, W=768, H=768, radius=1.0,
                 fovy=30, use_texture=True, device=None):
        self.device = resolve_device(device)
        self.W, self.H = W, H
        self.cam = OrbitCamera(W, H, r=radius, fovy=fovy, convention="opengl")

        with np.load(param_path) as z:
            self.params = dict(z)
        # archives may be truncated relative to n_shape/n_expr
        self.n_timesteps = self.params["expr"].shape[0]
        n_shape = min(n_shape, self.params["shape"].shape[0])
        n_expr = min(n_expr, self.params["expr"].shape[1])

        self.head = FlameHead.build(n_shape=n_shape, n_expr=n_expr,
                                    asset_dir=asset_dir, add_teeth=add_teeth,
                                    device=self.device)
        self.settings = RenderSettings(lighting_type="front")
        self.lights = (self._t(self.params["lights"])[None]
                       if "lights" in self.params else None)
        self.tex = None
        self.verts_uv = None
        if use_texture:
            tex = FlameTexPainted(self.head.assets.tex_painted, 512, device=self.device)()
            if "tex_extra" in self.params:
                res = self._t(self.params["tex_extra"])[None]
                if tex.shape[-2:] != res.shape[-2:]:
                    # jax.image.resize's bilinear (see FlameTexPainted)
                    tex = F.interpolate(tex, size=res.shape[-2:], mode="bilinear",
                                        align_corners=False, antialias=True)
                tex = tex + res
            self.tex = tex
            self.verts_uv = render_verts_uv(self.head, self.device)

        self._verts_cache = {}

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def flame_verts(self, t: int) -> torch.Tensor:
        if t not in self._verts_cache:
            p = self.params
            with torch.no_grad():
                verts = self.head(
                    shape=self._t(p["shape"][:self.head.n_shape])[None],
                    expr=self._t(p["expr"][t, :self.head.n_expr])[None],
                    rotation=self._t(p["rotation"][t])[None],
                    neck=self._t(p["neck_pose"][t])[None],
                    jaw=self._t(p["jaw_pose"][t])[None],
                    eyes=self._t(p["eyes_pose"][t])[None],
                    translation=self._t(p["translation"][t])[None],
                    zero_centered_at_root_node=False,
                    return_landmarks=False,
                    static_offset=(self._t(p["static_offset"])
                                   if "static_offset" in p else None),
                )
            self._verts_cache[t] = verts
        return self._verts_cache[t]

    def render_frame(self, t: int) -> np.ndarray:
        """Timestep t from the orbit camera -> (H, W, 3) uint8 on white."""
        verts = self.flame_verts(t)
        RT = self._t(self.cam.world_view_transform[None, :3])
        K = self._t(self.cam.intrinsics[None])
        with torch.no_grad():
            out = render_rgba_vis(
                verts, self.head.faces, RT, K, (self.H, self.W), self.settings,
                verts_uv=self.verts_uv, faces_uv=self.head.textures_idx,
                tex=self.tex, lights=self.lights)
        return composite_on_white(out["rgba"][0])

    # -- headless -----------------------------------------------------------

    def render_sequence(self, out_dir: Path, video: bool = False, fps: int = 25):
        from PIL import Image
        out_dir = Path(out_dir)
        frame_dir = out_dir / "frames"
        frame_dir.mkdir(parents=True, exist_ok=True)
        for t in range(self.n_timesteps):
            Image.fromarray(self.render_frame(t)).save(
                frame_dir / f"{t:05d}.png")
        logger.info(f"rendered {self.n_timesteps} frames to {frame_dir}")
        if video and shutil.which("ffmpeg"):
            vid = out_dir / "sequence.mp4"
            subprocess.run([
                "ffmpeg", "-y", "-v", "warning", "-framerate", str(fps),
                "-i", str(frame_dir / "%05d.png"),
                "-c:v", "libx264", "-pix_fmt", "yuv420p", str(vid)],
                check=True)
            logger.info(f"wrote {vid}")

    # -- interactive ----------------------------------------------------------

    def run_gui(self):
        dpg = require_dearpygui("the headless mode")

        dpg.create_context()
        state = {"t": 0, "playing": False}

        with dpg.texture_registry():
            init = self.render_frame(0).astype(np.float32) / 255.0
            rgba = np.concatenate([init, np.ones_like(init[..., :1])], -1)
            dpg.add_raw_texture(self.W, self.H, rgba.ravel(),
                                format=dpg.mvFormat_Float_rgba, tag="frame")

        def update():
            img = self.render_frame(state["t"]).astype(np.float32) / 255.0
            rgba = np.concatenate([img, np.ones_like(img[..., :1])], -1)
            dpg.set_value("frame", rgba.ravel())

        with dpg.window(tag="main", width=self.W, height=self.H + 60):
            dpg.add_image("frame")
            dpg.add_slider_int(label="timestep", min_value=0,
                               max_value=self.n_timesteps - 1,
                               callback=lambda s, v: (state.update(t=v), update()))

        def on_drag(sender, app_data):
            self.cam.orbit(app_data[1], app_data[2])
            update()

        with dpg.handler_registry():
            dpg.add_mouse_drag_handler(callback=on_drag)
            dpg.add_mouse_wheel_handler(
                callback=lambda s, v: (self.cam.scale(v), update()))

        dpg.create_viewport(title="vhap_tpu_torch viewer", width=self.W,
                            height=self.H + 80)
        dpg.setup_dearpygui()
        dpg.show_viewport()
        dpg.start_dearpygui()
        dpg.destroy_context()


def main(argv=None) -> FlameViewer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--param_path", type=Path, required=True)
    ap.add_argument("--out_dir", type=Path, default=Path("viewer_out"))
    ap.add_argument("--n_shape", type=int, default=300)
    ap.add_argument("--n_expr", type=int, default=100)
    ap.add_argument("--no-teeth", action="store_true")
    ap.add_argument("--asset_dir", "--model.asset_dir", dest="asset_dir", type=Path,
                    default=None, help="FLAME asset folder (default: the asset loader's)")
    ap.add_argument("--video", action="store_true")
    ap.add_argument("--interactive", action="store_true")
    ap.add_argument("--size", type=int, default=768)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    viewer = FlameViewer(args.param_path, args.n_shape, args.n_expr,
                         add_teeth=not args.no_teeth, asset_dir=args.asset_dir,
                         W=args.size, H=args.size, device=args.device)
    if args.interactive:
        viewer.run_gui()
    else:
        viewer.render_sequence(args.out_dir, video=args.video)
    return viewer


if __name__ == "__main__":
    main()
