"""The CUDA kernels against their plain versions on the card. These tests
need an NVIDIA GPU and nvcc and skip without them; run them on the card
with ``python -m pytest -m cuda tests/test_torch_cuda.py`` (this file
imports no JAX, so it also runs where JAX is not installed)."""
import pytest
import torch

from repro_torch.core import projector, quant
from repro_torch.kernels import LAUNCHES, ops, ref
from repro_torch.kernels import int8_matmul as ti8

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("M", [1, 3, 8, 16, 17, 100, 300])
@pytest.mark.parametrize("K,N", [(64, 64), (300, 300), (1000, 2048),
                                 (5461, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_matches_plain(cuda, M, K, N, dtype):
    """2e-2 of max|plain| (the JAX package's kernel tolerance); small-M and
    tiled paths, ragged K, padded N, K splits."""
    g = torch.Generator(device=cuda).manual_seed(M * 7 + K)
    qt = quant.quantize_blockwise(torch.randn((K, N), generator=g,
                                              device=cuda), 8,
                                  symmetric=True)
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    LAUNCHES.clear()
    got = ti8.int8_matmul(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert LAUNCHES["int8_matmul"] == 1
    want = ref.int8_matmul_ref(x, qt.q, qt.scale, 256)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 2e-2
    # padded columns dequantize to zero
    assert (got[:, N:] == 0).all()


def test_quantized_dense_launches_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    qt = quant.quantize_blockwise(torch.randn((300, 700), generator=g,
                                              device=cuda), 8,
                                  symmetric=True)
    x = torch.randn((2, 5, 300), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    LAUNCHES.clear()
    got = ops.quantized_dense(x, qt, dtype=torch.bfloat16)
    assert got.shape == (2, 5, 700) and got.dtype == torch.bfloat16
    assert LAUNCHES["int8_matmul"] == 1 and LAUNCHES["deq_matmul"] == 0
    want = ref.deq_matmul(x.reshape(10, 300), qt.q, qt.scale, 256, 700)
    assert _rel(got.reshape(10, 700).float(), want) <= 2e-2


def test_wrapper_rejects_non_contiguous(cuda):
    qt = quant.quantize_blockwise(torch.randn((256, 256), device=cuda), 8,
                                  symmetric=True)
    x = torch.randn((256, 4), device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        ti8.int8_matmul(x, qt.q, qt.scale)


@pytest.mark.parametrize("M", [1, 17, 100, 300])
@pytest.mark.parametrize("K,N", [(64, 256), (300, 512), (127, 768),
                                 (5461, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_t_matches_plain(cuda, M, K, N, dtype):
    """2e-2 of max|plain|; ragged K (the output width), row masking."""
    g = torch.Generator(device=cuda).manual_seed(M * 11 + K)
    qt = quant.quantize_blockwise(torch.randn((K, N), generator=g,
                                              device=cuda), 8,
                                  symmetric=True)
    go = torch.randn((M, N), generator=g, device=cuda).to(dtype)
    LAUNCHES.clear()
    got = ti8.int8_matmul_t(go, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert LAUNCHES["int8_matmul_t"] == 1
    want = ref.int8_matmul_t_ref(go, qt.q, qt.scale, 256)
    assert got.shape == (M, K) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 2e-2


def _fused_problem(dev, m, n, r, side, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    qt = quant.quantize_blockwise(
        torch.randn((m, n), generator=g, device=dev) * 0.02, 8,
        symmetric=True)
    d = n if side == "right" else m
    P = torch.linalg.qr(torch.randn((d, r), generator=g, device=dev))[0]
    qp = projector.quantize_projection(P, 4, 256)
    low_shape = (m, r) if side == "right" else (r, n)
    low = torch.randn(low_shape, generator=g, device=dev)
    m32 = torch.randn(low_shape, generator=g, device=dev) * 0.1
    v32 = (torch.randn(low_shape, generator=g, device=dev) * 0.01).abs()
    u01 = torch.rand(qt.q.shape, generator=g, device=dev)
    return qt, qp, low, m32, v32, u01


@pytest.mark.parametrize("m,n,r,side", [
    (512, 256, 32, "right"), (256, 512, 32, "left"),
    (300, 200, 24, "right"), (200, 300, 24, "left"),
    (5461 // 43, 2048 // 8, 64, "right"), (2048 // 8, 5461 // 43, 64, "left"),
])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_fused_update_matches_plain(cuda, m, n, r, side, wd):
    """The same uniforms: codes within one INT8 quantum (nearly all
    equal), scales and moments within 1e-5 relative."""
    qt, qp, low, m32, v32, u01 = _fused_problem(cuda, m, n, r, side, m + n)
    kw = dict(side=side, gscale=0.25, weight_decay=wd)
    LAUNCHES.clear()
    got, mg, vg = ops.fused_qgalore_update(qt, low, m32, v32, qp, 3, 1e-2,
                                           u01, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_qgalore_update"] == 1
    assert LAUNCHES["fused_qgalore_update_ref"] == 0
    cpu = lambda t: t.to("cpu")
    want, mw, vw = ops.fused_qgalore_update(
        qt.to("cpu"), cpu(low), cpu(m32), cpu(v32), qp.to("cpu"), 3, 1e-2,
        cpu(u01), **kw)
    dq_g = quant.dequantize(got.to("cpu"), torch.float32)
    dq_w = quant.dequantize(want, torch.float32)
    quantum = want.scale.max().item()
    assert (dq_g - dq_w).abs().max().item() <= quantum + 1e-6
    assert (got.q.cpu() == want.q)[:, :n].float().mean().item() > 0.999
    for a, b in ((got.scale, want.scale), (mg, mw), (vg, vw)):
        assert _rel(a.cpu(), b) <= 1e-5


def test_training_steps_go_through_the_kernels(cuda):
    """llama-60m smoke for one refresh and two steady steps on the card:
    finite losses, the kernels launched and the plain versions not, and
    the first loss equal to the CPU run's from the same state and
    batches."""
    from repro_torch.config import QGaLoreConfig, TrainConfig
    from repro_torch.core.optimizers import preset
    from repro_torch.models import model_zoo
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import Trainer

    qcfg = preset("qgalore", QGaLoreConfig(rank=8, min_dim=32,
                                           update_interval=4))
    tcfg = TrainConfig(seed=0, global_batch=4, seq_len=32, steps=3,
                       learning_rate=1e-2, warmup_steps=1, log_every=0)
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    lm = SyntheticLM(DataConfig(vocab_size=512, seq_len=32, global_batch=4))
    runs = {}
    for dev in ("cpu", "cuda"):
        bundle = model_zoo.build_arch("llama-60m", smoke=True, device=dev,
                                      dtype=torch.float32)
        state = step_lib.init_state(
            model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                                 dtype=torch.float32), qcfg, seed=0)
        state = _to(state, dev)
        tr = Trainer(bundle, tcfg, qcfg, state=state, batches=lambda s: {
            k: v.to(dev) for k, v in lm.batch_at(s).items()})
        LAUNCHES.clear()
        runs[dev] = ([h["loss"] for h in tr.run()], dict(LAUNCHES))
    (l_cpu, n_cpu), (l_gpu, n_gpu) = runs["cpu"], runs["cuda"]
    assert all(torch.isfinite(torch.tensor(l_gpu)))
    assert abs(l_gpu[0] - l_cpu[0]) <= 1e-4 * abs(l_cpu[0])
    per_step = 7 * 2 + 1
    assert n_gpu["int8_matmul"] == 3 * (2 * per_step - 1)
    assert n_gpu["int8_matmul_t"] == 3 * per_step
    assert n_gpu["fused_qgalore_update"] == 2 * per_step
    for name in ("int8_matmul_ref", "int8_matmul_t_ref", "deq_matmul",
                 "deq_matmul_t", "fused_qgalore_update_ref"):
        assert n_gpu.get(name, 0) == 0, name
    assert n_cpu.get("int8_matmul", 0) == 0


def _to(state, dev):
    """A TrainState moved to ``dev``."""
    from repro_torch.core.adam8bit import Adam8bitState
    from repro_torch.core.qgalore import QGaLoreState
    from repro_torch.train.step import TrainState

    def mv(t):
        if isinstance(t, dict):
            return {k: mv(v) for k, v in t.items()}
        return None if t is None else t.to(dev)
    opt = state.opt
    return TrainState(mv(state.params), QGaLoreState(
        [Adam8bitState(mv(i.m), mv(i.v)) for i in opt.inner],
        [mv(p) for p in opt.proj], opt.count))
