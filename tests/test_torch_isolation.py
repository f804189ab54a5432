"""The port stands alone: no file of repro_torch, nor chip_smoke.py,
imports jax or the JAX package, and its entry points refuse to fall back
to the CPU when no device was named and no card is present."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.models import model_zoo
from repro_torch.serve import engine, params as tparams, scheduler

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    assert path.exists(), path
    bad = FORBIDDEN & set(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.serve.scheduler, "
            "repro_torch.kernels.int8_matmul, repro_torch.kernels.build, "
            "repro_torch.launch.train, repro_torch.train.trainer, "
            "repro_torch.train.checkpoint, repro_torch.core.rules, "
            "repro_torch.core.transform, repro_torch.models.lora, "
            "repro_torch.launch.finetune; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad; print('clean')")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_without_device(no_card):
    cfg = model_zoo.get_config("llama-60m", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_zoo.build(cfg)
    bundle = model_zoo.build(cfg, device="cpu", dtype=torch.float32)
    params = tparams.prepare_params(
        bundle.init_params(torch.Generator().manual_seed(0)), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparams.prepare_params({"w": torch.zeros(4, 64)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.generate(bundle, params,
                        {"tokens": torch.ones((1, 3), dtype=torch.int32)},
                        steps=1, max_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scheduler.Scheduler(bundle, params, num_slots=1, max_len=8)
    # with device="cpu" the same calls run the plain versions
    toks, _ = engine.generate(bundle, params,
                              {"tokens": torch.ones((1, 3),
                                                    dtype=torch.int32)},
                              steps=1, max_len=8, device="cpu")
    assert tuple(toks.shape) == (1, 2)


def test_unported_architectures_raise():
    with pytest.raises(ValueError, match="not ported"):
        model_zoo.get_config("gemma-7b")
    tied = model_zoo.get_config("llama-60m", smoke=True)
    from repro_torch.config import replace
    with pytest.raises(NotImplementedError, match="tied"):
        model_zoo.build(replace(tied, tie_embeddings=True), device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        scheduler.make_scheduler(None, None, backend="paged", num_slots=1,
                                 max_len=8)
