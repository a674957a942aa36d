"""The import rule: nothing the benchmark runs loads JAX or the JAX
package (top-level module names compared whole: the program's own name
begins with the JAX package's), the reference imports nothing of the
program, and a run without a card or without the program prints no
result."""
import ast
import json
import shutil
import subprocess
import sys
import textwrap

from port_bench.harness import common
from port_bench.harness.common import BENCH_DIR, REPO_DIR


def test_forbidden_names_compared_whole(monkeypatch):
    for name in ("nerf_pytorch_paeng_tpu_torch", "nerf_pytorch_paeng_tpu_x",
                 "jaxtyping", "flaxen.sub"):
        monkeypatch.setitem(sys.modules, name, object())
    before = common.forbidden_modules()
    for name in ("jax.numpy", "nerf_pytorch_paeng_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, object())
    assert "jax" not in before and "nerf_pytorch_paeng_tpu" not in before
    assert set(common.forbidden_modules()) - set(before) == {
        "jax", "nerf_pytorch_paeng_tpu"}


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert set(tops) <= {"torch", "math", "typing", "__future__"}, \
                (path.name, tops)


def test_a_cell_loads_neither_jax_nor_the_jax_package():
    """Both kinds of cell at a small size on the CPU, in a fresh
    interpreter: afterwards the program is loaded and nothing forbidden
    is."""
    code = textwrap.dedent("""
        import sys, json, torch
        from port_bench.run import make_ctx, run_cell
        from port_bench.harness.common import forbidden_modules
        small = dict(N_rays=128, N_samples_c=8, N_samples_f=8)
        for cell, scene in (("lego.train", dict(H=16, W=16, n_train=2)),
                            ("fern.render", dict(H=12, W=16, n_views=4,
                                                 testskip=2))):
            run_cell(make_ctx(cell, 5, 1.0, False, torch.device("cpu"),
                              0.0, nerf_overrides=small,
                              scene_overrides=scene))
        tops = sorted({m.split(".")[0] for m in sys.modules})
        print(json.dumps({"forbidden": forbidden_modules(), "tops": tops}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_DIR,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert "nerf_pytorch_paeng_tpu_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "nerf_pytorch_paeng_tpu"} & set(
        got["tops"])


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "lego.train",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        return                        # the card's case is the benchmark's
    out = _run(REPO_DIR)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO_DIR / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
