"""The PyTorch port stands alone: no JAX, no vhap_tpu, and the card by default.

vhap_tpu_torch and chip_smoke.py must import neither `jax` nor the JAX
package (`vhap_tpu`), not even its JAX-free modules; entry points run on
the CUDA device unless asked for the CPU, and a kernel wrapper never falls
back to its plain version for a CUDA tensor.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "vhap_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "vhap_tpu")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_default_device_is_cuda(monkeypatch):
    from vhap_tpu_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from vhap_tpu_torch.model.assets import load_flame_assets
    from vhap_tpu_torch.model.flame import FlameHead
    from vhap_tpu_torch.preprocess import landmarks, matting, star, video
    from vhap_tpu_torch.tracker.params import init_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assets = load_flame_assets(asset_dir="/nonexistent_force_synth", seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlameHead.build(n_shape=4, n_expr=2, assets=assets, add_teeth=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(2, 4, 2, 1, 10, 8, True, True, True, True, False, False)
    # the preprocess networks and entry points: the card unless asked
    small_star = star.init_star_params(nstack=1, depth=1, feats=8)
    for make in (landmarks.LandmarkDetectorFANNet,
                 lambda: landmarks.LandmarkDetectorSTARNet(params=small_star),
                 matting.MattingUNet,
                 lambda: matting.matting_unet(tmp_path),
                 lambda: video.preprocess(tmp_path / "clip.mp4",
                                          matting_method="matting_jax"),
                 lambda: landmarks.annotate_landmarks(None, source="fan-jax")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_kernel_wrappers_take_no_cpu_fallback():
    """The autograd Functions behind the wrappers launch or raise; they
    never compute a CPU tensor's result themselves."""
    from vhap_tpu_torch.ops.interp import _FusedInterp
    from vhap_tpu_torch.ops.rasterize import SETUP_ROW, _Visibility
    from vhap_tpu_torch.ops.texture_fetch import _TrilinearSample
    with pytest.raises(ValueError, match="CUDA tensor"):
        _Visibility.apply(torch.zeros(1, 4, SETUP_ROW), 8, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _FusedInterp.apply(torch.zeros(1, 36, 4),
                           torch.zeros(1, 8, 8, dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _TrilinearSample.apply(torch.zeros(21, 3), torch.zeros(1, 2, 2, 2),
                               torch.zeros(1, 2, 2, 4), None, (0, 16, 20),
                               ((4, 4), (2, 2), (1, 1)))


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Without CUDA (as here), or without the repository around it,
    chip_smoke.py exits non-zero and prints no result line."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd, script = tmp_path, tmp_path / "chip_smoke.py"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_plane_gather_wrapper_takes_no_cpu_fallback():
    """K6's autograd Function launches or raises; the wrapper takes the
    plain version only for a CPU tensor."""
    from vhap_tpu_torch.ops.plane_gather import _PlaneGather, plane_gather
    tri = torch.zeros(1, 8, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _PlaneGather.apply(torch.zeros(1, 3, 4), tri)
    assert plane_gather(torch.ones(1, 3, 4), tri).shape == (1, 3, 8, 8)


def test_vis_entry_points_default_to_the_card(monkeypatch):
    """The vis slice builds on the card unless given device='cpu'."""
    from vhap_tpu_torch.tools.vis_slice import build_vis_slice
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_vis_slice(batch_size=1, image_size=(8, 8), tex_res=8,
                        n_shape=2, n_expr=2)


def test_trainer_and_viewer_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """The synthetic trainers, the viewer and the editor build on the card
    unless given device='cpu' (--device cpu)."""
    from vhap_tpu_torch import flame_editor, flame_viewer
    from vhap_tpu_torch.tools import train_fan_synthetic, train_matting_synthetic
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (train_fan_synthetic.FanTrainer,
                 train_matting_synthetic.MattingTrainer,
                 lambda: train_fan_synthetic.main(["--steps", "1", "--out",
                                                   str(tmp_path / "f.npz")]),
                 lambda: flame_viewer.FlameViewer(tmp_path / "none.npz"),
                 lambda: flame_editor.main(["--out", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_native_loader_builds_outside_the_package():
    """The frame loader's library goes to build/native at the repository
    root, never into a package directory, and importing the port built
    nothing."""
    from vhap_tpu_torch.data import native_loader
    assert native_loader.BUILD_DIR == REPO / "build" / "native"
    assert not list(PORT.rglob("*.so"))

def test_sharding_module_is_scanned():
    """parallel/sharding.py, the counterpart of vhap_tpu/parallel/
    sharding.py, is among the sources held to the rules above."""
    assert PORT / "parallel" / "sharding.py" in _port_sources()


def test_several_devices_need_cards_or_the_cpu(monkeypatch, tmp_path):
    """exp.num_devices asks for cards unless the CPU is asked for; NCCL has
    no CPU fallback."""
    from vhap_tpu_torch import track
    from vhap_tpu_torch.parallel import sharding
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.plan(4)
    assert sharding.plan(4, "cpu") == (["cpu"] * 4, "gloo")
    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        sharding.init("nccl", 0, 1, (tmp_path / "rdv").as_uri(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        track.main(["--data.root_folder", str(tmp_path), "--exp.num_devices", "2"])
