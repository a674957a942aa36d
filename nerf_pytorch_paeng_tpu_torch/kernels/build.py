"""Build the CUDA sources under ``kernels/csrc`` at first use.

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The library's name carries a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source rebuilds and a
stale library is never loaded.  The build directory is
``<repo>/build/kernels`` (git-ignored) unless ``use_build_dir`` names
another: the config's ``compile_cache`` ("auto" that directory, "off" a
fresh temporary directory for the process, else the directory given),
the counterpart of the JAX package's persistent compilation cache.
``build_all`` runs one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Iterable, List

from ..utils.spans import setup_span

SRC_DIR = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
BUILD_DIR = DEFAULT_BUILD_DIR
_process_tmp: List[Path] = []     # compile_cache "off": made once a process
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (put the CUDA toolkit on PATH): the port's "
            "kernels are built from source at first use")
    return found


def resolve_build_dir(compile_cache: str) -> Path:
    """The build directory that ``compile_cache`` names: "auto" the
    repository's ``build/kernels``, "off" a fresh temporary directory
    (one a process, removed at exit), anything else that directory."""
    spec = str(compile_cache).strip()
    if spec.lower() == "auto":
        return DEFAULT_BUILD_DIR
    if spec.lower() == "off":
        if not _process_tmp:
            tmp = Path(tempfile.mkdtemp(prefix="nerf_kernels_"))
            atexit.register(shutil.rmtree, tmp, True)
            _process_tmp.append(tmp)
        return _process_tmp[0]
    return Path(spec).expanduser().resolve()


def use_build_dir(compile_cache: str) -> Path:
    """Point every later build at ``resolve_build_dir(compile_cache)``
    and return it.  A library already loaded stays loaded."""
    global BUILD_DIR
    BUILD_DIR = resolve_build_dir(compile_cache)
    return BUILD_DIR


def library_path(name: str) -> Path:
    text = (SRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(SRC_DIR.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names: Iterable[str]) -> List[Path]:
    """Compile each ``csrc/<name>.cu`` whose library for this exact source
    does not exist, one ``nvcc`` per source, all started together.  The
    compiler's resource report (-Xptxas -v) is kept beside each library as
    ``.log``."""
    names = list(names)
    outs = [library_path(name) for name in names]
    jobs = []
    try:
        for name, out in zip(names, outs):
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
            jobs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, out, tmp, proc in jobs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu:\n{log}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str) -> Path:
    """``build_all`` for one source."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """Load the library for ``csrc/<name>.cu``, building it if needed
    (set-up span ``setup.kernels``)."""
    with setup_span("setup.kernels"):
        return ctypes.CDLL(str(build(name)))
