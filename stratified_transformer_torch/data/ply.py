"""Minimal PLY reader/writer and ``.obj`` reader and writers (no external
deps; the JAX package's ``data/ply.py``, copied so that the port imports
none of it).

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


def save_colored_by_label(path, xyz, labels, fmt="ply"):
    """Label-coloured dump (``write_ply_color``; ``fmt="obj"``:
    ``save_obj_color_coding``'s vertex lines with colours in [0, 1])."""
    labels = np.asarray(labels).astype(np.int64) % len(COLOR_MAP)
    rgb = COLOR_MAP[labels]
    if fmt == "ply":
        write_ply_points(path, xyz, rgb)
    else:  # obj
        with open(path, "w") as f:
            for p, c in zip(np.asarray(xyz), rgb / 255.0):
                f.write(f"v {p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")


def load_obj_vertices(path):
    """Vertices of an .obj mesh (``util/iostream.py:50`` capability)."""
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
    return np.asarray(verts, np.float32)


# 29-entry instance color map (reference ``util/iostream.py:7-37``, itself
# from the MinkowskiEngine indoor example).
CUBOID_COLOR_MAP = {
    0: (0.0, 0.0, 0.0), 1: (255.0, 152.0, 150.0), 2: (174.0, 199.0, 232.0),
    3: (152.0, 223.0, 138.0), 4: (255.0, 187.0, 120.0),
    5: (188.0, 189.0, 34.0), 6: (140.0, 86.0, 75.0), 7: (31.0, 119.0, 180.0),
    8: (214.0, 39.0, 40.0), 9: (197.0, 176.0, 213.0),
    10: (148.0, 103.0, 189.0), 11: (196.0, 156.0, 148.0),
    12: (23.0, 190.0, 207.0), 13: (200.0, 54.0, 131.0),
    14: (247.0, 182.0, 210.0), 15: (66.0, 188.0, 102.0),
    16: (219.0, 219.0, 141.0), 17: (140.0, 57.0, 197.0),
    18: (202.0, 185.0, 52.0), 19: (51.0, 176.0, 203.0),
    20: (200.0, 54.0, 131.0), 21: (92.0, 193.0, 61.0),
    22: (78.0, 71.0, 183.0), 23: (172.0, 114.0, 82.0),
    24: (255.0, 127.0, 14.0), 25: (91.0, 163.0, 138.0),
    26: (153.0, 98.0, 156.0), 27: (0.0, 0.0, 0.0),
    28: (158.0, 218.0, 229.0),
}


def save_obj(path, points, colors=None):
    """Vertex-only .obj dump (reference ``util/iostream.py:138-146``)."""
    with open(path, "w") as f:
        if colors is None:
            for v in np.asarray(points):
                f.write(f"v {v[0]:.4f} {v[1]:.4f} {v[2]:.4f}\n")
        else:
            for v, c in zip(np.asarray(points), np.asarray(colors)):
                f.write(f"v {v[0]:.4f} {v[1]:.4f} {v[2]:.4f} "
                        f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")


def save_obj_color_coding(path, points, labels):
    """Label-colored .obj dump (reference ``util/iostream.py:149-154``)."""
    n = len(CUBOID_COLOR_MAP)
    cols = [CUBOID_COLOR_MAP[int(l) % n] for l in np.asarray(labels)]
    save_obj(path, points, cols)


def save_obj_line(path, end_pts1, end_pts2):
    """Line-segment .obj dump (reference ``util/iostream.py:157-166``)."""
    p1 = np.asarray(end_pts1)
    p2 = np.asarray(end_pts2)
    with open(path, "w") as f:
        for v1, v2 in zip(p1, p2):
            f.write(f"v {v1[0]:.4f} {v1[1]:.4f} {v1[2]:.4f}\n")
            f.write(f"v {v2[0]:.4f} {v2[1]:.4f} {v2[2]:.4f}\n")
        for i in range(len(p1)):
            f.write(f"l {i * 2 + 1} {i * 2 + 2}\n")
