"""The port stands alone: no module of nerf_pytorch_paeng_tpu_torch, and
not chip_smoke.py or the port's card tools, imports JAX (or flax, optax,
orbax) or the JAX package, and the packaging ships the kernel sources."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "nerf_pytorch_paeng_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "nerf_pytorch_paeng_tpu")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_files():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "torch_kernel_ab.py",
        ROOT / "tools" / "torch_distill_study.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert path.exists(), path
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, (path, bad)


def test_kernel_sources_are_package_data():
    text = (ROOT / "pyproject.toml").read_text()
    assert "nerf_pytorch_paeng_tpu_torch" in text
    assert "csrc/*.cu" in text and "csrc/*.cuh" in text
    assert list((PORT / "kernels" / "csrc").glob("*.cu"))
    assert list((PORT / "kernels" / "csrc").glob("*.cuh"))


@pytest.mark.parametrize(
    "path", sorted((PORT / "kernels" / "csrc").glob("*.cu*")),
    ids=lambda p: p.name)
def test_kernel_sources_use_no_wmma(path):
    """Every kernel runs on wgmma and TMA (csrc/hopper_mma.cuh): no source
    uses the older warp-level wmma API or includes its header."""
    text = path.read_text()
    assert "wmma" not in text and "nvcuda" not in text, path
    assert "<mma.h>" not in text, path
