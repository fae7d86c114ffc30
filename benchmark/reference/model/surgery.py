"""Build-time mesh surgery for the FLAME template.

Counterpart of vhap_tpu/model/surgery.py (reference: the procedural mesh
edits of vhap/model/flame.py:206-561): teeth built from the lip rings,
inner-lip stitching and removal, torso removal and torso-deformation
disabling, in numpy, once, before FlameHead.build turns the arrays into
buffers.
"""

from __future__ import annotations

import numpy as np

from reference.model.assets import FlameAssets, load_topology_tables
from reference.model.masks import FlameMasks


def add_teeth(a: FlameAssets, masks: FlameMasks, n_shape: int) -> None:
    """Procedurally add 120 teeth vertices + 168 faces (vhap/model/flame.py:206-504).

    Teeth geometry is derived from the outer lip rings: a middle plane,
    upper/lower edges and roots, front and back shells. Upper teeth are
    rigidly bound to the neck joint, lower teeth to the jaw joint; their
    shape basis copies the mean of the lip-ring shape dirs so identity
    changes carry the teeth along.
    """
    tables = load_topology_tables()

    vid_upper = masks.get_vid_by_region(["lip_outside_ring_upper"], keep_order=True)
    vid_lower = masks.get_vid_by_region(["lip_outside_ring_lower"], keep_order=True)
    v_lip_upper = a.v_template[vid_upper]
    v_lip_lower = a.v_template[vid_lower]

    mean_dist = np.linalg.norm(v_lip_upper - v_lip_lower, axis=-1, keepdims=True).mean()
    v_mid = (v_lip_upper + v_lip_lower) / 2
    v_mid[:, 1] = v_mid[:, 1].mean()
    v_mid[:, 2] -= mean_dist * 1.5  # distance of teeth behind the lips

    up = np.array([0.0, mean_dist, 0.0], dtype=a.v_template.dtype)
    back = np.array([0.0, 0.0, mean_dist], dtype=a.v_template.dtype)

    upper_edge = v_mid + up * 0.1
    upper_root = upper_edge + up * 2
    lower_edge = v_mid - up * 0.1 - back * 0.4
    lower_root = lower_edge - up * 2

    thickness = mean_dist * 1.0
    upper_root_back = upper_root.copy(); upper_root_back[:, 2] -= thickness
    upper_edge_back = upper_edge.copy(); upper_edge_back[:, 2] -= thickness
    lower_root_back = lower_root.copy(); lower_root_back[:, 2] -= thickness
    lower_edge_back = lower_edge.copy(); lower_edge_back[:, 2] -= thickness

    V0 = a.v_template.shape[0]
    v_teeth = np.concatenate([
        upper_root, lower_root, upper_edge, lower_edge,
        upper_root_back, upper_edge_back, lower_root_back, lower_edge_back,
    ], axis=0)
    n_teeth = v_teeth.shape[0]  # 120
    a.v_template = np.concatenate([a.v_template, v_teeth], axis=0)

    grp = lambda i: np.arange(15 * i, 15 * (i + 1)) + V0
    vid_ur, vid_lr, vid_ue, vid_le = grp(0), grp(1), grp(2), grp(3)
    vid_urb, vid_ueb, vid_lrb, vid_leb = grp(4), grp(5), grp(6), grp(7)
    vid_teeth_upper = np.concatenate([vid_ur, vid_ue, vid_urb, vid_ueb])
    vid_teeth_lower = np.concatenate([vid_lr, vid_le, vid_lrb, vid_leb])
    vid_teeth = np.concatenate([vid_teeth_upper, vid_teeth_lower])

    # region bookkeeping (vhap/model/flame.py:276-289)
    masks.v["teeth_upper"] = vid_teeth_upper
    masks.v["teeth_lower"] = vid_teeth_lower
    masks.v["teeth"] = vid_teeth
    if "left_half" in masks.v and "vmask_teeth_ext/left_half" in tables:
        masks.v["left_half"] = np.concatenate(
            [masks.v["left_half"], tables["vmask_teeth_ext/left_half"]])
        masks.v["right_half"] = np.concatenate(
            [masks.v["right_half"], tables["vmask_teeth_ext/right_half"]])

    # teeth UV layout: a strip near the top edge of the texture
    # (vhap/model/flame.py:291-300)
    u = np.linspace(0.62, 0.38, 15)
    v = np.linspace(1 - 0.0083, 1 - 0.0425, 7)[[3, 2, 0, 1, 3, 4, 6, 5]]
    uv = np.stack(np.meshgrid(u, v, indexing="ij"), axis=-1)  # (15, 8, 2)
    uv = uv.transpose(1, 0, 2).reshape(n_teeth, 2).astype(a.verts_uvs.dtype)
    Vt0 = a.verts_uvs.shape[0]
    a.verts_uvs = np.concatenate([a.verts_uvs, uv], axis=0)

    # blendshapes: teeth copy the mean lip-ring shape dirs (identity only),
    # zero expression contribution (vhap/model/flame.py:302-312)
    n_basis = a.shapedirs.shape[2]
    sd_teeth = np.zeros((n_teeth, 3, n_basis), dtype=a.shapedirs.dtype)
    sd_mean = (a.shapedirs[vid_upper, :, :n_shape] + a.shapedirs[vid_lower, :, :n_shape]) / 2
    sd_teeth[:, :, :n_shape] = np.tile(sd_mean, (8, 1, 1))  # all 8 teeth rows share the mean dirs
    a.shapedirs = np.concatenate([a.shapedirs, sd_teeth], axis=0)

    # posedirs zero, J_regressor zero for new verts
    a.posedirs = np.concatenate(
        [a.posedirs, np.zeros((n_teeth, 3, a.posedirs.shape[2]), a.posedirs.dtype)], axis=0)
    a.J_regressor = np.concatenate(
        [a.J_regressor, np.zeros((a.J_regressor.shape[0], n_teeth), a.J_regressor.dtype)], axis=1)

    # lbs: upper teeth follow the neck joint (1), lower the jaw joint (2)
    # (vhap/model/flame.py:322-325)
    w_teeth = np.zeros((n_teeth, a.lbs_weights.shape[1]), a.lbs_weights.dtype)
    a.lbs_weights = np.concatenate([a.lbs_weights, w_teeth], axis=0)
    a.lbs_weights[vid_teeth_upper, 1] += 1
    a.lbs_weights[vid_teeth_lower, 2] += 1

    f_up = tables["faces/f_teeth_upper"].astype(np.int32)
    f_lo = tables["faces/f_teeth_lower"].astype(np.int32)
    a.faces = np.concatenate([a.faces, f_up + V0, f_lo + V0], axis=0).astype(np.int32)
    a.textures_idx = np.concatenate(
        [a.textures_idx, f_up + Vt0, f_lo + Vt0], axis=0).astype(np.int32)

    masks.num_verts = a.v_template.shape[0]
    masks.update(a.faces, a.textures_idx)


def connect_lip_inside(a: FlameAssets, masks: FlameMasks) -> None:
    """Stitch the inner lip rings closed (vhap/model/flame.py:507-542).

    NOTE (reference quirk, replicated): textures_idx is NOT extended, so the
    uv-face table goes out of sync; the option defaults to off.
    """
    tables = load_topology_tables()
    f_connect = tables["faces/f_lip_connect"].astype(np.int32)
    a.faces = np.concatenate([a.faces, f_connect], axis=0).astype(np.int32)
    masks.update(a.faces)


def remove_lip_inside(a: FlameAssets, masks: FlameMasks) -> None:
    """Drop inner-lip faces (vhap/model/flame.py:544-548)."""
    fid = masks.get_fid_except_region(["lip_inside"])
    a.faces = a.faces[fid]
    a.textures_idx = a.textures_idx[fid]
    masks.update(a.faces, a.textures_idx)


def remove_torso(a: FlameAssets, masks: FlameMasks) -> None:
    """Drop boundary/torso faces (vhap/model/flame.py:550-554).

    Reference quirk replicated: textures_idx is left untouched.
    """
    fid = masks.get_fid_except_region(["boundary"])
    a.faces = a.faces[fid]
    masks.update(a.faces, a.textures_idx)


def disable_deformation_on_torso(a: FlameAssets, masks: FlameMasks, n_expr: int) -> None:
    """Zero expression dirs + last-3 lbs weights on the torso boundary
    (vhap/model/flame.py:556-561)."""
    vid = masks.get_vid_by_region(["boundary", "neck_lower"])
    a.shapedirs[vid, :, -n_expr:] = 0
    vid = masks.get_vid_by_region(["boundary"])
    a.lbs_weights[vid, -3:] = 0
