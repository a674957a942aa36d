"""Parser for COLMAP's sparse-model files (cameras/images/points3D),
binary and text formats.

Own copy of the JAX package's ``data/colmap/read_model.py`` (reference
dataset/colmap/colmap_read_model.py: read_cameras_binary:109,
read_images_binary:169, read_points3d_binary:231, the text readers at
:83-261, and the extension-dispatching read_model:262-270), with plain
dataclasses and numpy.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import BinaryIO, Dict, Tuple

import numpy as np

# camera model id -> (name, #params), per COLMAP src/base/camera_models.h
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    id: int
    qvec: np.ndarray       # [4] (w, x, y, z)
    tvec: np.ndarray       # [3]
    camera_id: int
    name: str
    xys: np.ndarray        # [P, 2]
    point3D_ids: np.ndarray  # [P] int64 (-1 = no 3D point)


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray        # [3]
    rgb: np.ndarray        # [3] uint8
    error: float
    image_ids: np.ndarray  # [T] int32
    point2D_idxs: np.ndarray  # [T] int32


def _read(fp: BinaryIO, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fp.read(size))


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cams: Dict[int, Camera] = {}
    with open(path, "rb") as fp:
        (n,) = _read(fp, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(fp, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(fp, f"<{n_params}d"))
            cams[cam_id] = Camera(cam_id, name, int(width), int(height),
                                  params)
    return cams


def read_images_binary(path: str) -> Dict[int, Image]:
    images: Dict[int, Image] = {}
    with open(path, "rb") as fp:
        (n,) = _read(fp, "<Q")
        for _ in range(n):
            image_id = _read(fp, "<i")[0]
            qvec = np.array(_read(fp, "<4d"))
            tvec = np.array(_read(fp, "<3d"))
            camera_id = _read(fp, "<i")[0]
            name_bytes = b""
            while True:
                c = fp.read(1)
                if c == b"\x00":
                    break
                name_bytes += c
            (n_pts,) = _read(fp, "<Q")
            data = np.frombuffer(fp.read(24 * n_pts),
                                 dtype=[("x", "<f8"), ("y", "<f8"),
                                        ("id", "<i8")])
            images[image_id] = Image(
                image_id, qvec, tvec, camera_id, name_bytes.decode("utf-8"),
                np.stack([data["x"], data["y"]], -1) if n_pts else
                np.zeros((0, 2)),
                data["id"].astype(np.int64))
    return images


def read_points3d_binary(path: str) -> Dict[int, Point3D]:
    points: Dict[int, Point3D] = {}
    with open(path, "rb") as fp:
        (n,) = _read(fp, "<Q")
        for _ in range(n):
            pid = _read(fp, "<Q")[0]
            xyz = np.array(_read(fp, "<3d"))
            rgb = np.array(_read(fp, "<3B"), np.uint8)
            (error,) = _read(fp, "<d")
            (track_len,) = _read(fp, "<Q")
            track = np.frombuffer(fp.read(8 * track_len),
                                  dtype=[("im", "<i4"), ("pt", "<i4")])
            points[pid] = Point3D(pid, xyz, rgb, float(error),
                                  track["im"].astype(np.int32),
                                  track["pt"].astype(np.int32))
    return points


# ---- text format -----------------------------------------------------------
# COLMAP writes text models as one record per line (images: two lines),
# '#'-prefixed comment lines anywhere in the header.

def _text_records(path: str):
    with open(path) as fp:
        for line in fp:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line.split()


def read_cameras_text(path: str) -> Dict[int, Camera]:
    """cameras.txt: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]"""
    cams: Dict[int, Camera] = {}
    for tok in _text_records(path):
        cam_id = int(tok[0])
        cams[cam_id] = Camera(cam_id, tok[1], int(tok[2]), int(tok[3]),
                              np.array([float(p) for p in tok[4:]]))
    return cams


def read_images_text(path: str) -> Dict[int, Image]:
    """images.txt, two lines per image:
    IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME
    then POINTS2D[] as (X, Y, POINT3D_ID) triplets.

    An image with zero registered 2D points writes an EMPTY points line —
    it must be consumed as that image's (empty) points record, not
    skipped, or the header/points alternation desynchronizes on every
    following image.  Hence raw line iteration here instead of
    _text_records (which drops blank lines)."""
    images: Dict[int, Image] = {}
    header = None
    with open(path) as fp:
        for line in fp:
            line = line.strip()
            if line.startswith("#"):
                continue
            if header is None:
                if not line:
                    continue        # blank separator between records
                header = line.split()
                continue
            tok = line.split()      # possibly [] (zero-point image)
            image_id = int(header[0])
            pts = np.array([float(t) for t in tok],
                           np.float64).reshape(-1, 3) if tok else \
                np.zeros((0, 3))
            images[image_id] = Image(
                image_id,
                np.array([float(q) for q in header[1:5]]),
                np.array([float(t) for t in header[5:8]]),
                int(header[8]), " ".join(header[9:]),
                pts[:, :2], pts[:, 2].astype(np.int64))
            header = None
    if header is not None:
        # trailing header whose points line was cut off (EOF): zero points
        image_id = int(header[0])
        images[image_id] = Image(
            image_id,
            np.array([float(q) for q in header[1:5]]),
            np.array([float(t) for t in header[5:8]]),
            int(header[8]), " ".join(header[9:]),
            np.zeros((0, 2)), np.zeros((0,), np.int64))
    return images


def read_points3d_text(path: str) -> Dict[int, Point3D]:
    """points3D.txt: POINT3D_ID X Y Z R G B ERROR TRACK[] as
    (IMAGE_ID, POINT2D_IDX) pairs."""
    points: Dict[int, Point3D] = {}
    for tok in _text_records(path):
        pid = int(tok[0])
        track = np.array([int(t) for t in tok[8:]],
                         np.int32).reshape(-1, 2)
        points[pid] = Point3D(
            pid, np.array([float(v) for v in tok[1:4]]),
            np.array([int(v) for v in tok[4:7]], np.uint8),
            float(tok[7]), track[:, 0], track[:, 1])
    return points


# ---- ext dispatch ----------------------------------------------------------

def detect_model_ext(sparse_dir: str) -> str:
    """'.bin' if a binary model is present, else '.txt' if a text model is,
    else raise. Binary wins when both exist (it is what COLMAP's mapper
    writes; text comes from model_converter exports)."""
    for ext in (".bin", ".txt"):
        if all(os.path.isfile(os.path.join(sparse_dir, n + ext))
               for n in ("cameras", "images", "points3D")):
            return ext
    raise FileNotFoundError(
        f"no complete COLMAP model (cameras/images/points3D .bin or .txt) "
        f"in {sparse_dir!r}")


def read_model(sparse_dir: str, ext: str | None = None
               ) -> Tuple[Dict[int, Camera], Dict[int, Image],
                          Dict[int, Point3D]]:
    """Read a sparse model directory in either format (reference
    colmap_read_model.py:262-270). ``ext`` in {'.bin', '.txt', None=auto}."""
    ext = ext or detect_model_ext(sparse_dir)
    p = lambda n: os.path.join(sparse_dir, n + ext)  # noqa: E731
    if ext == ".bin":
        return (read_cameras_binary(p("cameras")),
                read_images_binary(p("images")),
                read_points3d_binary(p("points3D")))
    if ext == ".txt":
        return (read_cameras_text(p("cameras")),
                read_images_text(p("images")),
                read_points3d_text(p("points3D")))
    raise ValueError(f"unknown COLMAP model ext {ext!r}")
