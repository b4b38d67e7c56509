"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and not ``scripts/torch_phase_ab.py`` imports JAX, anything of the JAX package ``repro`` or the
reference's top-level ``benchmarks`` folder (which imports both) — the
card's machine has neither.  Checked on the source with ``ast``, so a
lazy import inside a function counts too."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_phase_ab.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "benchmarks")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [f"{path.name}:{line} imports {name}"
           for line, name in _imports(path) if _forbidden(name)]
    assert not bad, bad


def test_guard_sees_what_it_must_refuse(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom repro.configs import x\n"
                   "def f():\n    import repro.kernels\n"
                   "from repro_torch import y\nimport reprox\n"
                   "from benchmarks import kernel_micro\n"
                   "from repro_torch.benchmarks import run\n")
    names = sorted(n for _, n in _imports(src) if _forbidden(n))
    assert names == ["benchmarks", "jax.numpy", "repro.configs",
                     "repro.kernels"]
    assert len(FILES) > 20


def test_guard_covers_the_quantized_path():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in ("serving/quantized_weights.py", "serving/quantized_cache.py",
                "kernels/gemv_cid.py"):
        assert f"src/repro_torch/{mod}" in names


def test_guard_covers_the_dense_path():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in ("kernels/flash_attention.py", "kernels/decode_attention.py",
                "kernels/ref.py", "models/attention.py",
                "models/transformer.py", "serving/engine.py",
                "launch/serve.py"):
        assert f"src/repro_torch/{mod}" in names


def test_guard_covers_the_ssm_path():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in ("kernels/ssd_scan.py", "models/ssm.py",
                "configs/mamba2_2p7b.py", "models/convert.py"):
        assert f"src/repro_torch/{mod}" in names


def test_guard_covers_the_benchmark_path():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in ("kernels/gemm_cim.py", "core/scheduler.py", "core/opgraph.py",
                "benchmarks/run.py", "benchmarks/kernel_micro.py",
                "benchmarks/paper_figs.py"):
        assert f"src/repro_torch/{mod}" in names


def test_guard_covers_the_prefix_and_speculative_path():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in ("serving/prefix_cache.py", "serving/speculative.py",
                "serving/sampling.py", "serving/kv_pool.py",
                "serving/executor.py", "serving/types.py"):
        assert f"src/repro_torch/{mod}" in names


def test_guard_covers_the_frontend_path():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in ("serving/tracing.py", "serving/frontend.py",
                "serving/traffic.py", "serving/metrics.py",
                "serving/scheduler.py"):
        assert f"src/repro_torch/{mod}" in names
