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


def _arch_reads(path: pathlib.Path):
    """The lines of ``path`` that read an attribute named ``arch``
    (``x.arch``, ``getattr(x, "arch")``), each with its enclosing
    function's name."""
    tree = ast.parse(path.read_text(), filename=str(path))

    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            inner = (child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn)
            if isinstance(child, ast.Attribute) and child.attr == "arch":
                yield child.lineno, fn
            elif (isinstance(child, ast.Call)
                  and isinstance(child.func, ast.Name)
                  and child.func.id == "getattr" and len(child.args) > 1
                  and isinstance(child.args[1], ast.Constant)
                  and child.args[1].value == "arch"):
                yield child.lineno, fn
            yield from walk(child, inner)
    return list(walk(tree, None))


def test_only_arch_reads_the_architecture():
    """Every decision on the architecture is taken behind
    ``nerf_pytorch_paeng_tpu_torch/arch/``: no other module of the package
    reads ``cfg.arch``, save ``NerfConfig.validate``'s check of the
    field."""
    bad = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT)
        if rel.parts[0] == "arch":
            continue
        for line, fn in _arch_reads(path):
            if not (rel == pathlib.Path("config.py") and fn == "validate"):
                bad.append(f"{rel}:{line}")
    assert not bad, bad


def test_every_architecture_gives_the_interface():
    """Every name ``arch.architecture`` accepts resolves to a module with
    every member of the interface, and its hook between chunks has both
    methods; any other name is refused, by ``architecture`` and by
    ``NerfConfig.validate``."""
    import numpy as np

    from nerf_pytorch_paeng_tpu_torch import NerfConfig
    from nerf_pytorch_paeng_tpu_torch.arch import (MEMBERS, NAMES,
                                                   architecture)

    K = np.array([[8.0, 0, 4.0], [0, 8.0, 4.0], [0, 0, 1]], np.float32)
    ext = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    for name in NAMES:
        cfg = NerfConfig(arch=name, device="cpu", global_batch=True)
        module = architecture(cfg.validate())
        missing = [m for m in MEMBERS if not callable(getattr(module, m,
                                                              None))]
        assert not missing, (name, missing)
        hook = module.chunk_hook(cfg, K, ext, (8, 8), np.arange(2), "cpu", 1)
        assert callable(hook.before) and callable(hook.next_boundary), name
    bad = NerfConfig(arch="mipnerf", device="cpu")
    for refuse in (bad.validate, lambda: architecture(bad)):
        with pytest.raises(ValueError, match="arch='mipnerf'"):
            refuse()
