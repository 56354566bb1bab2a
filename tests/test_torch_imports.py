"""The port stands alone: no module of ``repro_torch`` nor ``chip_smoke.py``
imports ``jax`` or ``repro``, and nothing in ``kernels/`` wraps a kernel
build or launch in a ``try`` that could give way to another path."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "repro", "jaxlib", "flax")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0], node.lineno


def test_port_has_the_expected_modules():
    names = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    for want in (
        "core/crossbar.py", "core/adc.py", "core/fixedpoint.py", "kernels/_build.py",
        "kernels/crossbar_vmm.py", "kernels/noisy_vmm.py", "kernels/ops.py",
        "device/models.py", "device/programmed.py", "checkpoint/checkpoint.py",
        "convert.py", "models/layers.py", "models/attention.py", "models/model.py",
        "serving/engine.py", "serving/graphs.py", "configs/smollm_360m.py", "configs/xlstm_350m.py",
        "configs/gemma2_9b.py", "configs/minitron_4b.py", "configs/starcoder2_3b.py",
        "kernels/slstm_scan.py", "models/xlstm.py",
        "core/karatsuba.py", "core/strassen.py", "core/planner.py", "core/workloads.py",
        "core/arch.py", "core/mapper.py", "core/energy.py", "analysis/store.py",
        "device/repair.py", "device/program.py", "device/health.py",
        "serving/kvcache.py", "serving/scheduler.py", "serving/farm.py",
        "models/moe.py", "configs/kimi_k2_1t.py",
        "tree.py", "optim/optimizers.py", "optim/schedules.py", "data/pipeline.py", "train/loop.py",
        "launch/train.py", "launch/mesh.py", "train/compression.py", "configs/deepseek_v2_236b.py",
        "launch/serve.py", "models/ssm.py", "configs/jamba_52b.py", "configs/musicgen_large.py",
        "configs/pixtral_12b.py", "launch/sharding.py", "models/parallel.py",
    ):
        assert want in names, want
    for src in ("crossbar_vmm.cu", "slstm_scan.cu"):
        assert (PORT / "kernels" / "csrc" / src).is_file(), src


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_and_no_reference_package_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(root, line) for root, line in _imported_roots(tree) if root in FORBIDDEN]
    assert not bad, f"{path}: forbidden imports {bad}"
    # dynamic imports by name would dodge the walk above
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", "")) in (
            "import_module", "__import__"
        ):
            raise AssertionError(f"{path}:{node.lineno}: dynamic import")


def test_no_try_around_kernel_build_or_launch():
    """A ``try`` in ``kernels/`` may only be a ``try/finally`` (cleanup);
    an ``except`` clause there could swallow a build or launch failure."""
    for path in sorted((PORT / "kernels").glob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Try):
                assert not node.handlers, f"{path}:{node.lineno}: try/except in kernels/"


def test_no_torch_compile_anywhere():
    for path in FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr == "compile":
                base = node.value
                assert not (isinstance(base, ast.Name) and base.id == "torch"), f"{path}:{node.lineno}"


def test_cuda_default_entry_points_raise_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be observed")
    from repro_torch.checkpoint import restore_programmed
    from repro_torch.configs import get_config, reduced
    from repro_torch.device import program_model
    from repro_torch.models import model as M
    from repro_torch.serving import ServingEngine

    cfg = reduced(get_config("smollm-360m"))
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_model(cfg, 0)
    params = M.init_model(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        program_model(params)
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_programmed("/nonexistent")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params)
