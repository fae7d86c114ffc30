"""OBJ/MTL text serialization (vhap/util/mesh.py:13-39); counterpart of
vhap_tpu/util/mesh_io.py."""

from __future__ import annotations

import io

import numpy as np


def get_mtl_content(tex_fname: str) -> str:
    return f"newmtl Material\nmap_Kd {tex_fname}\n"


def _block(arr, fmt: str) -> str:
    """Row-formatted text block — np.savetxt is ~10x the per-row f-string
    loop this replaced (the eval mesh dump serializes millions of rows on
    a 1-core host; it dominated end-of-run wall-clock)."""
    buf = io.StringIO()
    np.savetxt(buf, np.asarray(arr), fmt=fmt)
    return buf.getvalue()


def get_obj_content(vertices, faces, uv_coordinates=None, uv_indices=None,
                    mtl_fname=None) -> str:
    parts = ["# Generated with vhap_tpu_torch\n"]
    if mtl_fname is not None:
        parts.append(f"mtllib {mtl_fname}\nusemtl Material\n")
    # %.9g: float32 needs 9 significant digits for exact round-trip
    parts.append(_block(vertices, "v %.9g %.9g %.9g"))
    if uv_coordinates is not None:
        parts.append(_block(uv_coordinates, "vt %.9g %.9g"))
    faces = np.asarray(faces)
    if uv_indices is not None:
        ft = np.empty((faces.shape[0], 6), np.int64)
        ft[:, 0::2] = faces + 1
        ft[:, 1::2] = np.asarray(uv_indices) + 1
        parts.append(_block(ft, "f %d/%d %d/%d %d/%d"))
    else:
        parts.append(_block(faces + 1, "f %d %d %d"))
    return "".join(parts)


def face_vertices(vertices, faces):
    """Per-face vertex gather: (B, V, C) x (B, F, 3) -> (B, F, 3, C)
    (vhap/util/mesh.py:54-72)."""
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    return vertices[np.arange(vertices.shape[0])[:, None, None], faces]
