"""Minimal PLY reader/writer and ``.obj`` vertex reader (no external deps;
the JAX package's ``data/ply.py`` as far as the layout-removal driver uses
it, copied so that the port imports none of it).

Replaces the reference's ``plyfile`` dependency
(``dataset/scannetv2/prepare_data_inst.py``) and the colored PLY dump
helpers of ``util/vis_util.py:32-99``. Supports ascii and
binary_little_endian, vertex properties only (plus face counts skipping).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path) -> Dict[str, np.ndarray]:
    """Returns {element_name: structured array} for vertex-style elements;
    list properties (faces) are returned as object arrays of int lists."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        assert magic == b"ply", f"not a ply file: {path}"
        fmt = None
        elements: List[Tuple[str, int, list]] = []
        while True:
            line = f.readline().strip().decode("ascii")
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                elements.append((name, int(count), []))
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elements[-1][2].append(
                        ("list", parts[2], parts[3], parts[4]))
                else:
                    elements[-1][2].append(("scalar", parts[1], parts[2]))
            elif line == "end_header":
                break
        out = {}
        for name, count, props in elements:
            if all(p[0] == "scalar" for p in props):
                dtype = np.dtype(
                    [(p[2], ("<" if fmt != "ascii" else "") + _TYPES[p[1]])
                     for p in props])
                if fmt == "ascii":
                    rows = [f.readline().split() for _ in range(count)]
                    arr = np.zeros(count, dtype)
                    for i, r in enumerate(rows):
                        for (pname, _), v in zip(dtype.fields.items(), r):
                            arr[pname][i] = float(v)
                else:
                    arr = np.frombuffer(
                        f.read(count * dtype.itemsize), dtype=dtype,
                        count=count).copy()
                out[name] = arr
            else:
                faces = []
                if fmt == "ascii":
                    for _ in range(count):
                        vals = f.readline().split()
                        n = int(vals[0])
                        faces.append([int(v) for v in vals[1:1 + n]])
                else:
                    cnt_t = np.dtype("<" + _TYPES[props[0][1]])
                    idx_t = np.dtype("<" + _TYPES[props[0][2]])
                    for _ in range(count):
                        n = int(np.frombuffer(
                            f.read(cnt_t.itemsize), cnt_t)[0])
                        faces.append(np.frombuffer(
                            f.read(n * idx_t.itemsize), idx_t).tolist())
                out[name] = np.asarray(faces, dtype=object)
        return out


def write_ply_points(path, xyz, rgb=None, binary=True):
    """Write a point cloud (optionally colored) as PLY
    (``util/vis_util.py`` ``write_ply_color*`` capability)."""
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    has_c = rgb is not None
    if has_c:
        rgb = np.asarray(rgb)
        if rgb.dtype != np.uint8:
            rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        hdr = ["ply",
               "format binary_little_endian 1.0" if binary
               else "format ascii 1.0",
               f"element vertex {n}",
               "property float x", "property float y", "property float z"]
        if has_c:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr.append("end_header")
        f.write(("\n".join(hdr) + "\n").encode("ascii"))
        if binary:
            if has_c:
                dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                               ("r", "u1"), ("g", "u1"), ("b", "u1")])
                arr = np.zeros(n, dt)
                arr["x"], arr["y"], arr["z"] = xyz.T
                arr["r"], arr["g"], arr["b"] = rgb.T
                f.write(arr.tobytes())
            else:
                f.write(xyz.astype("<f4").tobytes())
        else:
            for i in range(n):
                row = f"{xyz[i, 0]} {xyz[i, 1]} {xyz[i, 2]}"
                if has_c:
                    row += f" {rgb[i, 0]} {rgb[i, 1]} {rgb[i, 2]}"
                f.write((row + "\n").encode("ascii"))


# 29-entry categorical color map (reference util/iostream.py:7-37 capability)
COLOR_MAP = np.asarray([
    [174, 199, 232], [152, 223, 138], [31, 119, 180], [255, 187, 120],
    [188, 189, 34], [140, 86, 75], [255, 152, 150], [214, 39, 40],
    [197, 176, 213], [148, 103, 189], [196, 156, 148], [23, 190, 207],
    [247, 182, 210], [219, 219, 141], [255, 127, 14], [158, 218, 229],
    [44, 160, 44], [112, 128, 144], [227, 119, 194], [82, 84, 163],
    [100, 85, 144], [255, 0, 0], [0, 255, 0], [0, 0, 255],
    [255, 255, 0], [0, 255, 255], [255, 0, 255], [128, 128, 0],
    [0, 128, 128]], np.uint8)


def save_colored_by_label(path, xyz, labels):
    """Label-coloured PLY dump (``write_ply_color``)."""
    labels = np.asarray(labels).astype(np.int64) % len(COLOR_MAP)
    write_ply_points(path, xyz, COLOR_MAP[labels])


def load_obj_vertices(path):
    """Vertices of an .obj mesh (``util/iostream.py:50`` capability)."""
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
    return np.asarray(verts, np.float32)
