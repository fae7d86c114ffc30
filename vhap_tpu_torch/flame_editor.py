"""FLAME parameter editor (vhap/flame_editor.py equivalent).

Counterpart of vhap_tpu/flame_editor.py. Sliders for neck, jaw, eyes and
expression parameters with optional region-mask highlighting and
LBS-weight colouring, rendered with the port's visualization render on the
card. The headless mode renders a grid sweep of one parameter instead and
works without a display; the interactive mode needs dearpygui and raises a
clear error without it. Nothing here needs matplotlib.

Usage:
    python -m vhap_tpu_torch.flame_editor --out /tmp/editor --param expr0 --sweep -2 2
    python -m vhap_tpu_torch.flame_editor --interactive [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from vhap_tpu_torch.device import resolve_device
from vhap_tpu_torch.flame_viewer import composite_on_white, require_dearpygui
from vhap_tpu_torch.model.flame import FlameHead
from vhap_tpu_torch.ops.render import RenderSettings, render_rgba_vis
from vhap_tpu_torch.util.camera_np import OrbitCamera
from vhap_tpu_torch.util.log import get_logger

logger = get_logger(__name__)

_PARAM_DIMS = {"neck": 3, "jaw": 3, "eyes": 6}


class FlameEditor:
    def __init__(self, n_shape=300, n_expr=100, add_teeth=True, asset_dir=None,
                 W=768, H=768, radius=1.0, fovy=30, highlight_region=None,
                 lbs_color=False, device=None):
        self.device = resolve_device(device)
        self.W, self.H = W, H
        self.cam = OrbitCamera(W, H, r=radius, fovy=fovy, convention="opengl")
        self.head = FlameHead.build(n_shape=n_shape, n_expr=n_expr,
                                    asset_dir=asset_dir, add_teeth=add_teeth,
                                    device=self.device)
        self.settings = RenderSettings(lighting_type="front")

        self.state = {
            "shape": np.zeros(n_shape, np.float32),
            "expr": np.zeros(n_expr, np.float32),
            "neck": np.zeros(3, np.float32),
            "jaw": np.zeros(3, np.float32),
            "eyes": np.zeros(6, np.float32),
        }

        # vertex color: region highlight or LBS weights as colors
        # (vhap/flame_editor.py:38-358, add_lbs_color at flame.py:563-569)
        v_color = np.ones((self.head.num_verts, 3), np.float32) * 0.8
        if lbs_color:
            w = self.head.lbs_weights.cpu().numpy()
            palette = np.asarray([[0.9, 0.1, 0.1], [0.1, 0.9, 0.1],
                                  [0.1, 0.1, 0.9], [0.9, 0.9, 0.1],
                                  [0.9, 0.1, 0.9]], np.float32)
            v_color = w @ palette[:w.shape[1]]
        elif highlight_region:
            ids = self.head.masks.get_vid_by_region([highlight_region])
            v_color[ids] = np.asarray([0.9, 0.2, 0.2], np.float32)
        self.v_color = torch.as_tensor(v_color, device=self.device)

    def render(self) -> np.ndarray:
        """The current state -> (H, W, 3) uint8 on white."""
        s = self.state
        t = lambda a: torch.as_tensor(a, device=self.device)[None]
        zeros = torch.zeros((1, 3), device=self.device)
        RT = torch.as_tensor(self.cam.world_view_transform[None, :3].astype(np.float32),
                             device=self.device)
        K = torch.as_tensor(self.cam.intrinsics[None].astype(np.float32),
                            device=self.device)
        with torch.no_grad():
            verts = self.head(
                shape=t(s["shape"]), expr=t(s["expr"]), rotation=zeros,
                neck=t(s["neck"]), jaw=t(s["jaw"]), eyes=t(s["eyes"]),
                translation=zeros, zero_centered_at_root_node=True,
                return_landmarks=False)
            out = render_rgba_vis(verts, self.head.faces, RT, K, (self.H, self.W),
                                  self.settings, v_color=self.v_color)
        return composite_on_white(out["rgba"][0])

    def set_param(self, name: str, values):
        if name.startswith("expr"):
            idx = int(name[4:] or 0)
            self.state["expr"][idx] = values if np.isscalar(values) else values[0]
        elif name.startswith("shape"):
            idx = int(name[5:] or 0)
            self.state["shape"][idx] = values if np.isscalar(values) else values[0]
        elif name in self.state:
            self.state[name][:len(np.atleast_1d(values))] = values
        else:
            raise KeyError(name)

    def render_sweep(self, out_dir: Path, param: str, lo: float, hi: float,
                     steps: int = 7):
        from PIL import Image
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        frames = []
        for v in np.linspace(lo, hi, steps):
            self.set_param(param, float(v))
            frames.append(self.render())
        grid = np.concatenate(frames, axis=1)
        path = out_dir / f"sweep_{param}.png"
        Image.fromarray(grid).save(path)
        logger.info(f"wrote {path}")
        return grid

    def run_gui(self):
        dpg = require_dearpygui("--param/--sweep headless mode")

        dpg.create_context()
        with dpg.texture_registry():
            init = self.render().astype(np.float32) / 255.0
            rgba = np.concatenate([init, np.ones_like(init[..., :1])], -1)
            dpg.add_raw_texture(self.W, self.H, rgba.ravel(),
                                format=dpg.mvFormat_Float_rgba, tag="frame")

        def update():
            img = self.render().astype(np.float32) / 255.0
            rgba = np.concatenate([img, np.ones_like(img[..., :1])], -1)
            dpg.set_value("frame", rgba.ravel())

        def slider_cb(param, idx):
            def cb(sender, value):
                self.state[param][idx] = value
                update()
            return cb

        with dpg.window(tag="view", width=self.W, height=self.H):
            dpg.add_image("frame")
        with dpg.window(tag="controls", label="FLAME parameters",
                        pos=(self.W, 0), width=320, height=self.H):
            for name, dim in _PARAM_DIMS.items():
                for i in range(dim):
                    dpg.add_slider_float(label=f"{name}[{i}]", min_value=-0.6,
                                         max_value=0.6,
                                         callback=slider_cb(name, i))
            for i in range(min(10, len(self.state["expr"]))):
                dpg.add_slider_float(label=f"expr[{i}]", min_value=-3.0,
                                     max_value=3.0, callback=slider_cb("expr", i))

        with dpg.handler_registry():
            dpg.add_mouse_drag_handler(
                callback=lambda s, a: (self.cam.orbit(a[1], a[2]), update()))
            dpg.add_mouse_wheel_handler(
                callback=lambda s, v: (self.cam.scale(v), update()))

        dpg.create_viewport(title="vhap_tpu_torch editor", width=self.W + 340,
                            height=self.H + 40)
        dpg.setup_dearpygui()
        dpg.show_viewport()
        dpg.start_dearpygui()
        dpg.destroy_context()


def main(argv=None) -> FlameEditor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=Path("editor_out"))
    ap.add_argument("--param", default="jaw")
    ap.add_argument("--sweep", type=float, nargs=2, default=(-0.3, 0.3))
    ap.add_argument("--steps", type=int, default=7)
    ap.add_argument("--n_shape", type=int, default=300)
    ap.add_argument("--n_expr", type=int, default=100)
    ap.add_argument("--asset_dir", "--model.asset_dir", dest="asset_dir", type=Path,
                    default=None, help="FLAME asset folder (default: the asset loader's)")
    ap.add_argument("--highlight_region", default=None)
    ap.add_argument("--lbs_color", action="store_true")
    ap.add_argument("--interactive", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    ed = FlameEditor(args.n_shape, args.n_expr, asset_dir=args.asset_dir,
                     highlight_region=args.highlight_region,
                     lbs_color=args.lbs_color, device=args.device)
    if args.interactive:
        ed.run_gui()
    else:
        # scalar sweeps set the first component of vector params (e.g. jaw x)
        ed.render_sweep(args.out, args.param, args.sweep[0], args.sweep[1],
                        args.steps)
    return ed


if __name__ == "__main__":
    main()
