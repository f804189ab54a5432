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
            "repro_torch.launch.finetune, repro_torch.serve.paged, "
            "repro_torch.serve.radix, repro_torch.models.model_zoo, "
            "repro_torch.models.transformer, repro_torch.models.attention, "
            "repro_torch.kernels.ops, repro_torch.data.synthetic, "
            "repro_torch.configs.mistral_nemo_12b, "
            "repro_torch.configs.yi_9b, repro_torch.configs.qwen3_32b, "
            "repro_torch.configs.gemma_7b, "
            "repro_torch.configs.internvl2_2b, repro_torch.models.moe, "
            "repro_torch.configs.qwen3_moe_30b_a3b, "
            "repro_torch.configs.deepseek_v3_671b, "
            "repro_torch.models.xlstm, repro_torch.models.xlstm_model, "
            "repro_torch.configs.xlstm_125m, repro_torch.kernels.profile, "
            "repro_torch.analysis.analytic, repro_torch.analysis.roofline, "
            "repro_torch.analysis.report, "
            "repro_torch.distributed.sharding, repro_torch.distributed.comm, "
            "repro_torch.distributed.zero, repro_torch.distributed.spawn, "
            "repro_torch.launch.mesh, repro_torch.serve.shard, "
            "repro_torch.launch.dryrun; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad; print('clean')")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


# the modules of the JAX package left unported on purpose: a backend
# registry with an autotune table (the port takes no registry and no
# environment switch), JAX ``shard_map`` shims, and XLA's HLO parsing
# (torch has no HLO; collectives are counted by ``distributed.comm.Comm``
# and the dry run's analytic payloads)
UNPORTED = {"kernels/dispatch.py", "compat.py", "analysis/hlo.py"}


def test_every_reference_module_has_a_counterpart():
    """Every ``src/repro/**/*.py`` has a file at the same path under
    ``src/repro_torch/``, or is on the list of modules unported on
    purpose (which names no module the port has)."""
    ref, port = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    missing = {str(p.relative_to(ref)) for p in ref.rglob("*.py")
               if not (port / p.relative_to(ref)).exists()}
    assert missing == UNPORTED
    assert not any((port / m).exists() for m in UNPORTED)


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
        model_zoo.get_config("gpt-2")
    # MoE (sub-slice 4b), MLA/MTP (4c), xLSTM (4d), the SSM hybrid (4e)
    # and the encoder-decoder (4f) are ported
    assert model_zoo.get_config("deepseek-v3-671b").attention == "mla"
    assert model_zoo.get_config("xlstm-125m").family == "xlstm"
    assert model_zoo.get_config("zamba2-2.7b").family == "hybrid"
    encdec = model_zoo.build(model_zoo.get_config("seamless-m4t-medium"),
                             device="meta")
    assert [s.name for s in encdec.segments] == ["encoder", "decoder"]
    assert not engine.append_ok(encdec)
    assert encdec.decode_extras == ("memory",)
    base = model_zoo.get_config("llama-60m", smoke=True)
    from repro_torch.config import MLAConfig, MoEConfig, replace
    mla = model_zoo.build(replace(base, attention="mla", mla=MLAConfig()),
                          device="cpu")
    assert mla.segments[0].append is None and not engine.append_ok(mla)
    moe = model_zoo.build(replace(base, moe=MoEConfig(
        num_experts=4, top_k=2, expert_ff=32)), device="cpu")
    assert [s.name for s in moe.segments] == ["moe"]
    assert model_zoo.get_config("qwen3-moe-30b-a3b").moe.num_experts == 128
    with pytest.raises(ValueError, match="unknown serving backend"):
        scheduler.make_scheduler(None, None, backend="bogus", num_slots=1,
                                 max_len=8)
