"""Subprocess bridge to the external COLMAP binary (SfM preprocessing).

Own copy of the JAX package's ``data/colmap/wrapper.py`` (reference
dataset/colmap/colmap_wrapper.py:22-83): ``colmap feature_extractor`` ->
``colmap <match_type>`` -> ``colmap mapper``, logging to
colmap_output.txt.  COLMAP stays an external binary: without it on PATH,
``run_colmap`` raises ``ColmapNotFound``.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import List


class ColmapNotFound(RuntimeError):
    pass


def _colmap_bin() -> str:
    path = shutil.which("colmap")
    if path is None:
        raise ColmapNotFound(
            "the `colmap` binary is not on PATH; install COLMAP or provide "
            "poses_bounds.npy directly")
    return path


def _run_logged(args: List[str], logfile) -> None:
    out = subprocess.run(args, capture_output=True, text=True)
    logfile.write(out.stdout)
    logfile.write(out.stderr)
    out.check_returncode()


def run_colmap(basedir: str, match_type: str = "exhaustive_matcher") -> None:
    """Feature extraction, matching and sparse mapping for basedir/images."""
    assert match_type in ("exhaustive_matcher", "sequential_matcher"), match_type
    colmap = _colmap_bin()
    db = os.path.join(basedir, "database.db")
    sparse = os.path.join(basedir, "sparse")
    os.makedirs(sparse, exist_ok=True)

    with open(os.path.join(basedir, "colmap_output.txt"), "w") as log:
        _run_logged([
            colmap, "feature_extractor",
            "--database_path", db,
            "--image_path", os.path.join(basedir, "images"),
            "--ImageReader.single_camera", "1",
        ], log)
        _run_logged([
            colmap, match_type,
            "--database_path", db,
        ], log)
        _run_logged([
            colmap, "mapper",
            "--database_path", db,
            "--image_path", os.path.join(basedir, "images"),
            "--output_path", sparse,
            "--Mapper.num_threads", "16",
            "--Mapper.init_min_tri_angle", "4",
            "--Mapper.multiple_models", "0",
            "--Mapper.extract_colors", "0",
        ], log)
    print(f"COLMAP sparse reconstruction done -> {sparse}/0")


def remove_colmap_artifacts(basedir: str) -> None:
    """Delete database/model/poses files for a clean relaunch
    (reference dataset/load_llff.py:64-75 / colmap/rmtest.py:4)."""
    for name in ("database.db", "colmap_output.txt", "poses_bounds.npy"):
        p = os.path.join(basedir, name)
        if os.path.exists(p):
            os.remove(p)
    sparse = os.path.join(basedir, "sparse")
    if os.path.isdir(sparse) and not os.path.islink(sparse):
        shutil.rmtree(sparse)
