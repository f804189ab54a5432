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


# small-M and tiled paths, ragged K, padded N; the tiled path's 64- and
# 128-row tiles with and without K splits at llama-1b's K
INT8_PROBLEMS = [(M, K, N) for M in (1, 3, 8, 16, 17, 100, 300)
                 for K, N in ((64, 64), (300, 300), (1000, 2048), (5461, 512))]
INT8_PROBLEMS += [(M, K, N) for M in (17, 64, 65, 128, 300, 2048)
                  for K, N in ((5461, 2048), (2048, 2048))]
# past the small path's K: the tiled path at M <= 16
INT8_PROBLEMS += [(M, 16448, 512) for M in (1, 8)]


@pytest.mark.parametrize("M,K,N", INT8_PROBLEMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_matches_plain(cuda, M, K, N, dtype):
    """Small-M and tiled paths, ragged K, padded N, K splits: 1e-4 of
    max|plain| where the kernel takes two passes (the small-M path, or f32
    x), else 2e-2 (the JAX package's kernel tolerance, one bf16 pass)."""
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
    two_pass = ti8.plan(M, K, qt.q.shape[1]).path == 0 or \
        dtype == torch.float32
    assert _rel(got, want) <= (1e-4 if two_pass else 2e-2)
    # padded columns dequantize to zero
    assert (got[:, N:] == 0).all()


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 5461), (5461, 2048),
                                 (2048, 32000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_small_m_llama_shapes(cuda, M, K, N, dtype):
    """The decode path at llama-1b's four (K, N), both dtypes: two passes
    (hi and lo of x * s) within 1e-4 of max|plain|, one launch, the padded
    columns exactly 0, and the same bits on a second call (the cluster's
    fixed reduction order)."""
    g = torch.Generator(device=cuda).manual_seed(M * 5 + K + N)
    qt = quant.quantize_blockwise(torch.randn((K, N), generator=g,
                                              device=cuda) * 0.02, 8,
                                  symmetric=True)
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    assert ti8.plan(M, K, qt.q.shape[1]).path == 0
    LAUNCHES.clear()
    got = ti8.int8_matmul(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert LAUNCHES["int8_matmul"] == 1
    want = ref.int8_matmul_ref(x, qt.q, qt.scale, 256)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4
    assert (got[:, N:] == 0).all()
    assert torch.equal(ti8.int8_matmul(x, qt.q, qt.scale), got)


@pytest.mark.parametrize("M,K,N", [(17, 2048, 2048), (300, 5461, 2048),
                                   (2048, 2048, 5632), (2048, 5461, 2048)])
def test_int8_matmul_f32_x_two_passes(cuda, M, K, N):
    """f32 x takes two bf16 passes (hi and lo of x * s) on the tensor
    cores: within 1e-4 of max|plain|, where one bf16 pass would be ~1e-3."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    qt = quant.quantize_blockwise(torch.randn((K, N), generator=g,
                                              device=cuda), 8,
                                  symmetric=True)
    x = torch.randn((M, K), generator=g, device=cuda)
    assert ti8.plan(M, K, N).path == 1
    got = ti8.int8_matmul(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    want = ref.int8_matmul_ref(x, qt.q, qt.scale, 256)
    assert _rel(got, want) <= 1e-4


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


def _int8_t_case(dev, M, K, N, dtype):
    g = torch.Generator(device=dev).manual_seed(M * 13 + K + N)
    qt = quant.quantize_blockwise(torch.randn((K, N), generator=g,
                                              device=dev) * 0.02, 8,
                                  symmetric=True)
    go = torch.randn((M, N), generator=g, device=dev).to(dtype)
    LAUNCHES.clear()
    got = ti8.int8_matmul_t(go, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert LAUNCHES["int8_matmul_t"] == 1
    want = ref.int8_matmul_t_ref(go, qt.q, qt.scale, 256)
    assert got.shape == (M, K) and torch.isfinite(got).all()
    return _rel(got, want)


# a llama-1b training step's four (K, N) problems, M = 2048 tokens and a
# ragged M
INT8_T_LLAMA = [(M, K, N) for M in (300, 2048)
                for K, N in ((2048, 2048), (2048, 5632), (5461, 2048),
                             (2048, 32000))]


@pytest.mark.parametrize("M,K,N", INT8_T_LLAMA)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_t_llama_shapes(cuda, M, K, N, dtype):
    """bf16 g (one tensor-core pass) within 2e-2 of max|plain|, f32 g (two
    passes, hi/lo) within 1e-4."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert _int8_t_case(cuda, M, K, N, dtype) <= tol


@pytest.mark.parametrize("M,K,N", [(17, 300, 2048), (100, 300, 2048),
                                   (129, 5461, 512), (300, 127, 32000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_t_ragged_tiles(cuda, M, K, N, dtype):
    """Row and output-column tiles cut short by M and K, the head's 125
    groups in one block: f32 g within 1e-4, bf16 g within 2e-2."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert _int8_t_case(cuda, M, K, N, dtype) <= tol


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


FUSED_SMALL = [(512, 256, 32, "right"), (256, 512, 32, "left"),
               (300, 200, 24, "right"), (200, 300, 24, "left"),
               (5461 // 43, 2048 // 8, 64, "right"),
               (2048 // 8, 5461 // 43, 64, "left")]
# a steady llama-1b training step's problems at rank 512: the padded
# 5632 columns and the ragged 5461 rows, the 32000-column head
FUSED_LLAMA_1B = [(2048, 2048, 512, "right"), (2048, 5461, 512, "left"),
                  (5461, 2048, 512, "right"), (2048, 32000, 512, "left")]
# a steady LLaMA-7B fine-tune step's problems at rank 8: P's quant block
# shrinks to the rank, which the kernel pads to its 32-rank step
FUSED_LLAMA_7B_R8 = [(4096, 4096, 8, "right"), (4096, 11008, 8, "left"),
                     (11008, 4096, 8, "right")]
STRESS_QUANTA = 256


def _stress_lr(qt, qp, low, m32, v32, count, side, gscale=0.25):
    """The lr at which lr * gscale * max|U| is STRESS_QUANTA quanta of the
    old scale: the step sets the new scales, and a direction rounded to
    bf16 (one pass) would move codes by more than the 0.999 bar."""
    m_hat = (0.9 * m32 + 0.1 * low) / (1 - 0.9 ** count)
    v_hat = (0.999 * v32 + 0.001 * low * low) / (1 - 0.999 ** count)
    d = m_hat / (torch.sqrt(v_hat) + 1e-8)
    P = quant.dequantize(qp, torch.float32)
    U = d @ P.T if side == "right" else P @ d
    return STRESS_QUANTA * qt.scale.max().item() / (gscale
                                                     * U.abs().max().item())


@pytest.mark.parametrize("m,n,r,side,step", [
    *[(*p, "run") for p in FUSED_SMALL],
    *[(*p, step) for p in FUSED_LLAMA_1B + FUSED_LLAMA_7B_R8
      for step in ("run", "stress")],
])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_fused_update_matches_plain(cuda, m, n, r, side, step, wd):
    """The same uniforms: codes within one INT8 quantum (nearly all
    equal), scales and moments within 1e-5 relative; at lr 1e-2, and at
    llama-1b's problems also at a stress step."""
    qt, qp, low, m32, v32, u01 = _fused_problem(cuda, m, n, r, side, m + n)
    lr = 1e-2 if step == "run" else _stress_lr(qt, qp, low, m32, v32, 3,
                                               side)
    kw = dict(side=side, gscale=0.25, weight_decay=wd)
    LAUNCHES.clear()
    got, mg, vg = ops.fused_qgalore_update(qt, low, m32, v32, qp, 3, lr,
                                           u01, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_qgalore_update"] == 1
    assert LAUNCHES["fused_qgalore_update_ref"] == 0
    cpu = lambda t: t.to("cpu")
    want, mw, vw = ops.fused_qgalore_update(
        qt.to("cpu"), cpu(low), cpu(m32), cpu(v32), qp.to("cpu"), 3, lr,
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


def test_two_ranks_on_one_card(cuda, tmp_path):
    """Two ranks on cuda:0 over gloo (NCCL refuses two ranks a card), one
    steady llama-60m smoke step, compressed data-parallel: the mean of
    the ranks' losses against the one-process step on the same 4 rows,
    the same weights after it, and the kernels launched in each rank."""
    import numpy as np

    import torch_dp_ranks as ranks
    from repro_torch.distributed.spawn import run_ranks
    one = ranks.steady_step(None, "cuda")
    two = run_ranks(ranks.steady_step, 2, "cuda", backend="gloo",
                    rendezvous_dir=str(tmp_path))
    assert two[0]["loss"] == two[1]["loss"]
    assert abs(two[0]["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
    same = sum(int((two[0]["codes"][k] == one["codes"][k]).sum())
               for k in one["codes"])
    assert same / sum(v.size for v in one["codes"].values()) >= 0.9999
    for k in one["codes"]:
        np.testing.assert_array_equal(two[0]["codes"][k], two[1]["codes"][k])
    per_step = 7 * 2 + 1
    for r in two:
        assert r["launches"]["int8_matmul"] == 2 * per_step - 1
        assert r["launches"]["int8_matmul_t"] == per_step
        assert r["launches"]["fused_qgalore_update"] == per_step
        for name in ("int8_matmul_ref", "int8_matmul_t_ref",
                     "fused_qgalore_update_ref", "deq_matmul"):
            assert r["launches"].get(name, 0) == 0, name


def test_finetune_run_on_the_card(cuda, tmp_path):
    """``launch.finetune.run`` at llama-60m smoke size on the card: the
    four contracts hold (``run`` raises otherwise), the report says
    Q-GaLore fits under QLoRA, and the three training kernels ran while
    no plain version did."""
    from repro_torch.launch import finetune
    LAUNCHES.clear()
    report = finetune.run(arch="llama-60m", smoke=True, steps=6, rank=8,
                          freeze_layers=1, out=str(tmp_path / "ft.json"),
                          device="cuda")
    torch.cuda.synchronize()
    assert report["qgalore_leq_qlora"] is True
    assert torch.isfinite(torch.tensor(report["final_loss"]))
    for name in ("int8_matmul", "int8_matmul_t", "fused_qgalore_update"):
        assert LAUNCHES[name] > 0, name
    for name in ("int8_matmul_ref", "int8_matmul_t_ref", "deq_matmul",
                 "deq_matmul_t", "fused_qgalore_update_ref"):
        assert LAUNCHES.get(name, 0) == 0, name


def _smoke_trainer(dev, path, steps, accum=1, **qkw):
    from repro_torch.config import QGaLoreConfig, TrainConfig
    from repro_torch.core.optimizers import preset
    from repro_torch.models import model_zoo
    from repro_torch.train.trainer import Trainer
    qcfg = preset("qgalore", QGaLoreConfig(rank=8, min_dim=32,
                                           update_interval=4, adaptive_k=1,
                                           cos_threshold=0.3, **qkw))
    tcfg = TrainConfig(seed=0, global_batch=4, seq_len=32, steps=steps,
                       learning_rate=1e-2, warmup_steps=2, log_every=0,
                       checkpoint_dir=str(path) if path else "",
                       checkpoint_every=5, async_checkpoint=False)
    bundle = model_zoo.build_arch("llama-60m", smoke=True, device=dev,
                                  dtype=torch.float32)
    return Trainer(bundle, tcfg, qcfg, accum=accum)


def test_randomized_subspace_on_the_card(cuda):
    """The range finder on the card against the CPU on the same gradients
    and test matrices: the same subspace (``P P^T`` within 1e-4)."""
    gen = torch.Generator().manual_seed(0)
    for shape, r in (((4, 256, 96), 16), ((2, 96, 320), 8)):
        G = torch.randn(shape, generator=gen)
        side = projector.galore_side(shape)
        om = torch.randn((shape[0],) + projector.omega_shape(shape, r, side),
                         generator=gen)
        P_cpu = projector.compute_subspace(G, r, side, "randomized", om)
        P_gpu = projector.compute_subspace(G.to(cuda), r, side, "randomized",
                                           om.to(cuda)).cpu()
        pp = lambda P: P @ P.transpose(-1, -2)
        assert (pp(P_gpu) - pp(P_cpu)).abs().max().item() <= 1e-4


def test_accum_checkpoint_and_rank_transition_on_the_card(cuda, tmp_path):
    """llama-60m smoke on the card at ``accum`` 2 with the randomized
    subspace and adaptive rank: a rank transition at step 8, a checkpoint
    written and restored mid-run, and the resumed tail equal to the
    uninterrupted run; the kernels launched, the plain versions not."""
    kw = dict(accum=2, subspace_method="randomized", galore_embeddings=True,
              adaptive_rank=True, rank_ladder=(4,),
              explained_ratio_threshold=0.3, rank_patience=3, min_rank=4)
    LAUNCHES.clear()
    tr_a = _smoke_trainer(cuda, tmp_path / "a", 12, **kw)
    hist_a = tr_a.run()
    assert all(torch.isfinite(torch.tensor([h["loss"] for h in hist_a])))
    assert tr_a.controller.rank_transition_summary()
    assert LAUNCHES["fused_qgalore_update"] > 0
    for name in ("int8_matmul_ref", "int8_matmul_t_ref", "deq_matmul",
                 "deq_matmul_t", "fused_qgalore_update_ref"):
        assert LAUNCHES.get(name, 0) == 0, name
    tr_b = _smoke_trainer(cuda, tmp_path / "b", 12, **kw)
    tr_b.run(7)
    tr_c = _smoke_trainer(cuda, tmp_path / "b", 12, **kw)
    assert tr_c.maybe_restore() == 7
    by_step = {h["step"]: h["loss"] for h in hist_a}
    for h in tr_c.run():
        assert abs(h["loss"] - by_step[h["step"]]) <= \
            1e-6 * abs(by_step[h["step"]]), h
    assert tr_c.controller.rank_transition_summary() == \
        tr_a.controller.rank_transition_summary()


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


def _flash_inputs(dev, B, S, H, KH, d, dv, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device=dev).to(dtype)
                 for s in ((B, S, H, d), (B, S, KH, d), (B, S, KH, dv)))


@pytest.mark.parametrize("B,S,H,KH,d,dv", [
    (1, 1, 2, 2, 64, 64), (2, 48, 4, 4, 64, 64), (1, 130, 8, 2, 64, 64),
    (2, 256, 4, 1, 128, 128), (1, 100, 2, 2, 48, 32), (1, 77, 3, 3, 16, 96),
    (1, 1, 4, 2, 128, 128), (1, 48, 4, 1, 64, 128), (2, 130, 4, 2, 128, 64),
    (1, 2048, 4, 2, 64, 64), (1, 2048, 2, 1, 128, 96), (1, 37, 2, 1, 20, 24),
    (1, 50, 2, 2, 64, 7),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(cuda, B, S, H, KH, d, dv, causal,
                                       dtype):
    """max|kernel - plain| / max|plain| <= 1e-4 in f32 (three passes on
    split operands) and 1e-2 with a bf16 output (one bf16 rounding); ragged
    S, native GQA, dv != d."""
    from repro_torch.kernels import flash_attention as tflash
    q, k, v = _flash_inputs(cuda, B, S, H, KH, d, dv, dtype, S + H)
    LAUNCHES.clear()
    got = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    assert LAUNCHES["flash_attention_ref"] == 0
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.shape == (B, S, H, dv) and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    assert _rel(got.float(), want) <= (1e-4 if dtype == torch.float32
                                       else 1e-2)


@pytest.mark.parametrize("B,S,H,KH", [(1, 512, 32, 32), (2, 130, 4, 4),
                                      (1, 300, 8, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_dim_80(cuda, B, S, H, KH, dtype):
    """zamba2-2.7b's site attention, d = dv = 80 (the kernel pads both to
    its 128-wide template), causal: within 1e-4 of max|plain| in f32 and
    1e-2 in bf16, one launch."""
    from repro_torch.kernels import flash_attention as tflash
    q, k, v = _flash_inputs(cuda, B, S, H, KH, 80, 80, dtype, S + 80)
    LAUNCHES.clear()
    got = tflash.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, causal=True)
    assert got.shape == (B, S, H, 80) and got.dtype == dtype
    assert _rel(got.float(), want) <= (1e-4 if dtype == torch.float32
                                       else 1e-2)


@pytest.mark.parametrize("R,C", [(1, 256), (37, 512), (128, 768),
                                 (300, 2048)])
def test_sr_requant_bit_exact(cuda, R, C):
    """Codes equal to the plain version's bit for bit, scales within
    1e-6 (true division, no FMA contraction)."""
    from repro_torch.kernels import sr_requant as tsr
    g = torch.Generator(device=cuda).manual_seed(R + C)
    qt = quant.quantize_blockwise(torch.randn((R, C), generator=g,
                                              device=cuda) * 0.02, 8,
                                  symmetric=True)
    upd = torch.randn((R, C), generator=g, device=cuda) * 1e-3
    u01 = torch.rand((R, C), generator=g, device=cuda)
    LAUNCHES.clear()
    q, s = tsr.sr_requant(qt.q, qt.scale, upd, u01)
    torch.cuda.synchronize()
    assert LAUNCHES["sr_requant"] == 1 and LAUNCHES["sr_requant_ref"] == 0
    qw, sw = ref.sr_requant_ref(qt.q, qt.scale, upd, u01, 256)
    assert torch.equal(q, qw)
    assert _rel(s, sw) <= 1e-6


@pytest.mark.parametrize("shape", [(1, 256), (33, 768), (3, 5, 300),
                                   (512, 2048)])
def test_blockwise_quant_bit_exact(cuda, shape):
    """Codes and scales equal to the plain version's and to
    ``core.quant.quantize_blockwise`` on the card, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=cuda) * 3
    LAUNCHES.clear()
    got = ops.quantize_int8(x)
    torch.cuda.synchronize()
    assert LAUNCHES["blockwise_quant"] == 1
    want = quant.quantize_blockwise(x, 8, symmetric=True)
    assert torch.equal(got.q, want.q) and torch.equal(got.scale, want.scale)
    x2 = torch.nn.functional.pad(x.reshape(-1, shape[-1]),
                                 (0, -shape[-1] % 256))
    qw, sw = ref.blockwise_quant_ref(x2, 256)
    assert torch.equal(got.q.reshape(qw.shape), qw)
    assert torch.equal(got.scale.reshape(sw.shape), sw)


@pytest.mark.parametrize("M,K,r", [(1, 64, 32), (37, 300, 64),
                                   (130, 1000, 100), (257, 2048, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_matmul_matches_plain(cuda, M, K, r, dtype):
    """2e-2 of max|plain| (the reference's tolerance); ragged M, K and R
    against the tiles."""
    from repro_torch.kernels import int4_matmul as ti4
    g = torch.Generator(device=cuda).manual_seed(M + K + r)
    P = torch.linalg.qr(torch.randn((K, r), generator=g, device=cuda))[0]
    qp = projector.quantize_projection(P, 4, 256)
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    LAUNCHES.clear()
    got = ti4.int4_matmul(x, qp.q, qp.scale, qp.zero, qp.block)
    torch.cuda.synchronize()
    assert LAUNCHES["int4_matmul"] == 1 and LAUNCHES["int4_matmul_ref"] == 0
    want = ref.int4_matmul_ref(x, qp.q, qp.scale, qp.zero, qp.block)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _rel(got, want) <= 2e-2


def _int4_case(dev, M, K, r, dtype, block=256):
    from repro_torch.kernels import int4_matmul as ti4
    g = torch.Generator(device=dev).manual_seed(M + 3 * K + r)
    P = torch.linalg.qr(torch.randn((K, r), generator=g, device=dev))[0]
    qp = projector.quantize_projection(P, 4, block)
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    LAUNCHES.clear()
    got = ti4.int4_matmul(x, qp.q, qp.scale, qp.zero, qp.block)
    torch.cuda.synchronize()
    assert LAUNCHES["int4_matmul"] == 1 and LAUNCHES["int4_matmul_ref"] == 0
    want = ref.int4_matmul_ref(x, qp.q, qp.scale, qp.zero, qp.block)
    assert got.shape == want.shape and torch.isfinite(got).all()
    return _rel(got, want), ti4.plan(M, K, qp.q.shape[1] * 2, qp.block)


@pytest.mark.parametrize("M", [2048, 5461])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_matmul_llama_shapes(cuda, M, dtype):
    """The unfused update's projections (K = 2048, R = 512, P blocks of
    256): f32 g (two passes) within 1e-4 of max|plain|, bf16 g within
    2e-2."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert _int4_case(cuda, M, 2048, 512, dtype)[0] <= tol


@pytest.mark.parametrize("M,K,r", [(1, 64, 32), (37, 300, 64),
                                   (130, 1000, 100), (257, 2048, 512)])
def test_int4_matmul_f32_two_passes(cuda, M, K, r):
    """f32 g on ragged M, K and R: within 1e-4 of max|plain|."""
    assert _int4_case(cuda, M, K, r, torch.float32)[0] <= 1e-4


@pytest.mark.parametrize("M,K,r,block,split", [
    (2048, 2048, 512, 256, True), (5461, 2048, 512, 256, False),
    (9000, 512, 512, 256, False), (37, 300, 64, 64, False),
    (130, 1000, 100, 100, True), (17000, 128, 128, 64, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_matmul_every_plan(cuda, M, K, r, block, split, dtype):
    """With and without the K split that ``plan`` chooses, on blocks of R
    of 64 and 100 (narrower than the 128-column tile, which masks the
    rest) and 256."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    rel, p = _int4_case(cuda, M, K, r, dtype, block)
    assert (p.splits > 1) == split
    assert rel <= tol


def test_unfused_chain_matches_cpu(cuda):
    """The unfused update on the card against the CPU's plain versions
    with the same uniforms: weights within one quantum, moments within
    1e-5."""
    m, n, r = 600, 512, 64
    qt, qp, _, m32, v32, u01 = _fused_problem(cuda, m, n, r, "right", 7)
    grad = torch.randn((m, n), device=cuda)
    LAUNCHES.clear()
    got, mg, vg = ops.unfused_qgalore_update(qt, grad, m32, v32, qp, 2,
                                             1e-2, u01, gscale=0.25)
    torch.cuda.synchronize()
    assert LAUNCHES["int4_matmul"] == 1 and LAUNCHES["sr_requant"] == 1
    cpu = lambda t: t.to("cpu")
    want, mw, vw = ops.unfused_qgalore_update(
        qt.to("cpu"), cpu(grad), cpu(m32), cpu(v32), qp.to("cpu"), 2, 1e-2,
        cpu(u01), gscale=0.25)
    dq = lambda t: quant.dequantize(t, torch.float32)
    assert (dq(got.to("cpu")) - dq(want)).abs().max().item() \
        <= want.scale.max().item() + 1e-6
    assert _rel(mg.cpu(), mw) <= 1e-5 and _rel(vg.cpu(), vw) <= 1e-5


def test_flash_prefill_matches_cpu(cuda):
    """A 2-layer llama-60m-width prefill through the flash route on the
    card against the CPU's plain route: logits within 2e-2 of
    max|logits|, one flash launch a layer, and no chunked attention."""
    from repro_torch.models import model_zoo
    from repro_torch.serve import engine
    from repro_torch.serve.params import quantize_leaf
    cfgs = {}
    for dev in ("cpu", "cuda"):
        cfgs[dev] = model_zoo.build_arch("llama-60m", smoke=True, device=dev,
                                         dtype=torch.float32,
                                         flash_attention=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    p_gpu = cfgs["cuda"].init_params(
        gen, leaf_fn=lambda _, t: quantize_leaf(t))

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        return t.to("cpu")

    toks = torch.randint(1, 512, (2, 40), generator=torch.Generator()
                         .manual_seed(1), dtype=torch.int32)
    out = {}
    for dev, params in (("cpu", to_cpu(p_gpu)), ("cuda", p_gpu)):
        LAUNCHES.clear()
        logits, _ = engine.build_prefill(cfgs[dev], 48)(
            params, {"tokens": toks.to(dev)})
        out[dev] = (logits.float().cpu(), dict(LAUNCHES))
    (l_c, n_c), (l_g, n_g) = out["cpu"], out["cuda"]
    assert n_g.get("flash_attention") == 2 and not n_g.get(
        "flash_attention_ref")
    assert n_c.get("flash_attention_ref") == 2
    assert _rel(l_g, l_c) <= 2e-2


def _smoke_on_both(cuda):
    """llama-60m smoke (f32) on the card and the CPU, on the same INT8
    codes drawn on the card."""
    from repro_torch.models import model_zoo
    from repro_torch.serve.params import quantize_leaf
    bundles = {dev: model_zoo.build_arch("llama-60m", smoke=True, device=dev,
                                         dtype=torch.float32)
               for dev in ("cpu", "cuda")}
    gen = torch.Generator(device=cuda).manual_seed(0)
    p_gpu = bundles["cuda"].init_params(
        gen, leaf_fn=lambda _, t: quantize_leaf(t))

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        return t.to("cpu")

    return bundles, {"cpu": to_cpu(p_gpu), "cuda": p_gpu}


@pytest.mark.parametrize("width", [1, 16])
def test_append_matches_prefill_on_the_card(cuda, width):
    """Chunked append on the card against one-shot prefill on the card,
    f32: last logits and the written cache within 1e-4 of max|ref|, every
    matmul through the kernel."""
    from repro_torch.serve import engine
    from repro_torch.serve.scheduler import init_pool
    bundles, params = _smoke_on_both(cuda)
    b, p = bundles["cuda"], params["cuda"]
    P, max_len = 40, 48
    prompt = torch.randint(1, 512, (1, P), generator=torch.Generator()
                           .manual_seed(1), dtype=torch.int32).to(cuda)
    want_l, want = engine.build_prefill(b, max_len)(p, {"tokens": prompt})
    append = engine.build_append(b, max_len)
    state = init_pool(b, 1, max_len, torch.float32, cuda)
    LAUNCHES.clear()
    for pos in range(0, P, width):
        n = min(width, P - pos)
        chunk = torch.zeros((1, width), dtype=torch.int32, device=cuda)
        chunk[0, :n] = prompt[0, pos:pos + n]
        logits, state = append(p, state, chunk,
                               torch.tensor([n], dtype=torch.int32,
                                            device=cuda))
    torch.cuda.synchronize()
    assert LAUNCHES["int8_matmul"] == 15 * -(-P // width)
    assert not LAUNCHES["deq_matmul"]
    assert _rel(logits, want_l) <= 1e-4
    for got, ref in zip(state.caches["seg0_dense"],
                        want.caches["seg0_dense"]):
        assert _rel(got[:, :, :P], ref[:, :, :P]) <= 1e-4
    assert int(state.lengths[0]) == P


def test_paged_scheduler_matches_cpu(cuda):
    """The paged scheduler on the card (kernels) against the CPU's (plain
    versions) on the same codes, f32, shared-prefix traffic: equal greedy
    tokens and equal stats."""
    import numpy as np
    from repro_torch.serve.paged import PagedScheduler
    from repro_torch.serve.scheduler import Request
    bundles, params = _smoke_on_both(cuda)
    rng = np.random.default_rng(3)
    prefix = rng.integers(1, 512, size=24)
    reqs = []
    for i in range(8):
        t = rng.integers(1, 512, size=int(rng.integers(3, 20)))
        if i % 2 == 0:
            t = np.concatenate([prefix, t])
        reqs.append((i, t.astype(np.int32).tolist(),
                     int(rng.integers(2, 8))))
    out = {}
    for dev in ("cpu", "cuda"):
        sched = PagedScheduler(bundles[dev], params[dev], num_slots=4,
                               max_len=64, block_size=8, prefill_chunk=8,
                               dtype=torch.float32, device=dev)
        LAUNCHES.clear()
        comps = sched.run([Request(*r) for r in reqs])
        out[dev] = ({c.rid: c.tokens for c in comps}, sched.stats,
                    dict(LAUNCHES))
        sched.alloc.check()
    (t_c, s_c, n_c), (t_g, s_g, n_g) = out["cpu"], out["cuda"]
    assert n_g.get("int8_matmul") and not n_g.get("deq_matmul")
    assert t_g == t_c and s_g == s_c
    assert s_g["radix_hit_blocks"] > 0


@pytest.mark.parametrize("K,N", [(2048, 2048), (5461, 2048), (2048, 5632),
                                 (25600, 5120)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_row_bit_equal_across_m(cuda, K, N, dtype):
    """A row's output does not depend on how many rows share the call: on
    the tiled path (M > 16, and M <= 16 past the small path's K) the K
    split follows K alone, and on the small-M path it follows N; so the
    first rows are bit-equal at every M a path takes."""
    g = torch.Generator(device=cuda).manual_seed(K + N)
    qt = quant.quantize_blockwise(torch.randn((K, N), generator=g,
                                              device=cuda) * 0.02, 8,
                                  symmetric=True)
    x = torch.randn((2048, K), generator=g, device=cuda).to(dtype)
    tiled = ti8.int8_matmul(x[:17], qt.q, qt.scale)
    for M in (17, 33, 64, 100, 128, 256, 512, 2048):
        assert ti8.plan(M, K, N).path == 1
        got = ti8.int8_matmul(x[:M].contiguous(), qt.q, qt.scale)
        assert torch.equal(got[:17], tiled), M
    small = ti8.int8_matmul(x[:1], qt.q, qt.scale)
    for M in (1, 2, 4, 8, 16):
        got = ti8.int8_matmul(x[:M].contiguous(), qt.q, qt.scale)
        assert torch.equal(got[:1], small), M


@pytest.mark.parametrize("M", [1, 8, 16, 300])
def test_quantized_dense_t_tied_head_shapes(cuda, M):
    """gemma-7b's tied head, ``h (M, 3072) bf16 @ deq(E (256000, 3072))^T``:
    one ``int8_matmul_t`` launch, within 1e-4 of max|plain| (bf16 g times
    the codes is exact in f32), the vocabulary uncropped."""
    g = torch.Generator(device=cuda).manual_seed(M)
    qt = quant.quantize_blockwise(torch.randn((256000, 3072), generator=g,
                                              device=cuda) * 0.02, 8,
                                  symmetric=True)
    x = torch.randn((M, 3072), generator=g, device=cuda).to(torch.bfloat16)
    LAUNCHES.clear()
    got = ops.quantized_dense_t(x, qt, dtype=torch.float32)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"int8_matmul_t": 1}
    assert tuple(got.shape) == (M, 256000)
    want = torch.cat([ref.int8_matmul_t_ref(x[i: i + 64], qt.q, qt.scale,
                                            256) for i in range(0, M, 64)])
    assert _rel(got, want) <= 1e-4


def test_gemma_smoke_serves_on_the_card(cuda):
    """gemma-7b's smoke config at f32 on the card against the CPU, the
    same codes: greedy tokens through ``make_scheduler`` (the paged
    runtime) equal, the card through ``int8_matmul`` and the tied head's
    ``int8_matmul_t``, the CPU through the plain versions."""
    from repro_torch.models import model_zoo
    from repro_torch.serve.params import quantize_leaf
    from repro_torch.serve.scheduler import Request, make_scheduler
    gpu = model_zoo.build_arch("gemma-7b", smoke=True, device="cuda",
                               dtype=torch.float32)
    cpu = model_zoo.build_arch("gemma-7b", smoke=True, device="cpu",
                               dtype=torch.float32)
    p_gpu = gpu.init_params(torch.Generator(device=cuda).manual_seed(0),
                            leaf_fn=lambda _, t: quantize_leaf(t))
    def to_cpu(t):
        return {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.to("cpu")

    p_cpu = to_cpu(p_gpu)
    reqs = [(i, [1 + (7 * i + j) % 500 for j in range(3 + 2 * i)], 4)
            for i in range(4)]
    out = {}
    for name, bundle, params in (("cuda", gpu, p_gpu), ("cpu", cpu, p_cpu)):
        sched = make_scheduler(bundle, params, num_slots=2, max_len=32,
                               block_size=4, prefill_chunk=8,
                               dtype=torch.float32, device=name)
        LAUNCHES.clear()
        comps = sched.run([Request(*r) for r in reqs])
        out[name] = ({c.rid: c.tokens for c in comps}, dict(LAUNCHES))
    assert out["cuda"][0] == out["cpu"][0]
    assert set(out["cuda"][1]) == {"int8_matmul", "int8_matmul_t"}
    assert set(out["cpu"][1]) == {"deq_matmul", "deq_matmul_t"}


# an MoE layer's expert problems at small widths: the small-M path (C <=
# 16, one split or a cluster of them), the tiled path (64- and 128-row
# tiles, a K split past TILED_KC), a padded N
BATCHED = [(E, M, K, N) for E in (1, 5) for M in (1, 4, 16, 17, 160)
           for K, N in ((64, 256), (300, 768), (768, 512))]
BATCHED += [(3, 40, 4200, 256), (128, 4, 2048, 768)]


def _batched_case(dev, E, M, K, N, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    qt = quant.quantize_blockwise(torch.randn((E, K, N), generator=g,
                                              device=dev), 8, symmetric=True)
    x = torch.randn((E, M, K), generator=g, device=dev).to(dtype)
    gr = torch.randn((E, M, qt.q.shape[-1]), generator=g,
                     device=dev).to(dtype)
    return qt, x, gr


@pytest.mark.parametrize("E,M,K,N", BATCHED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_kernels_match_plain(cuda, E, M, K, N, dtype):
    """``int8_matmul_batched`` and ``int8_matmul_t_batched`` against their
    plain versions, one launch each for all E experts: phase 2's bars
    (1e-4 where the kernel takes two passes, else 2e-2) and 1e-4 for the
    transpose (bf16 g is exact in its products)."""
    qt, x, gr = _batched_case(cuda, E, M, K, N, dtype, E * 31 + M + K)
    LAUNCHES.clear()
    got = ti8.int8_matmul_batched(x, qt.q, qt.scale)
    got_t = ti8.int8_matmul_t_batched(gr, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert LAUNCHES["int8_matmul_batched"] == 1
    assert LAUNCHES["int8_matmul_t_batched"] == 1
    assert not LAUNCHES["int8_matmul"] and not LAUNCHES["int8_matmul_t"]
    want = ref.int8_matmul_batched_ref(x, qt.q, qt.scale, 256)
    want_t = ref.int8_matmul_t_batched_ref(gr, qt.q, qt.scale, 256)
    two_pass = ti8.plan(M, K, qt.q.shape[-1], E=E).path == 0 or \
        dtype == torch.float32
    assert _rel(got, want) <= (1e-4 if two_pass else 2e-2)
    assert _rel(got_t, want_t) <= 1e-4


@pytest.mark.parametrize("E,M,K,N", [(5, 4, 300, 768), (5, 160, 768, 512),
                                     (128, 4, 2048, 768),
                                     (3, 40, 4200, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_rows_bit_equal_to_the_2d_kernel(cuda, E, M, K, N, dtype):
    """Each expert's rows of one batched launch equal, bit for bit, the
    2-D kernel on that expert's problem at the batched call's plan (the
    expert axis changes no summation order), and the transpose's equal the
    2-D ``int8_matmul_t``'s."""
    qt, x, gr = _batched_case(cuda, E, M, K, N, dtype, 7 + M)
    got = ti8.int8_matmul_batched(x, qt.q, qt.scale)
    got_t = ti8.int8_matmul_t_batched(gr, qt.q, qt.scale)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    p = ti8.plan(M, K, qt.q.shape[-1], sms, E)
    for e in range(E):
        one = ti8.int8_matmul(x[e].contiguous(), qt.q[e], qt.scale[e], p=p)
        one_t = ti8.int8_matmul_t(gr[e].contiguous(), qt.q[e], qt.scale[e])
        assert torch.equal(got[e], one), e
        assert torch.equal(got_t[e], one_t), e


@pytest.mark.parametrize("M", [4, 512])
@pytest.mark.parametrize("K,N", [(7168, 2048), (2048, 7168)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_rows_bit_equal_at_deepseek_experts(cuda, M, K, N, dtype):
    """deepseek-v3's expert problems (E 256, d 7168, expert_ff 2048; M 4 a
    decode dispatch at 4 slots, 512 a prompt): each expert's rows of one
    batched launch equal, bit for bit, the 2-D kernel at the batched
    call's plan, and the transpose's the 2-D ``int8_matmul_t``'s. Codes
    and scales are drawn directly (the float32 stack would be 15 GB)."""
    E = 256
    g = torch.Generator(device=cuda).manual_seed(K + M)
    q = torch.randint(-127, 128, (E, K, N), generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand((E, K, N // 256), generator=g, device=cuda) * 1e-3
    x = torch.randn((E, M, K), generator=g, device=cuda).to(dtype)
    gr = torch.randn((E, M, N), generator=g, device=cuda).to(dtype)
    LAUNCHES.clear()
    got = ti8.int8_matmul_batched(x, q, s)
    got_t = ti8.int8_matmul_t_batched(gr, q, s)
    assert LAUNCHES["int8_matmul_batched"] == 1
    assert LAUNCHES["int8_matmul_t_batched"] == 1
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    p = ti8.plan(M, K, N, sms, E)
    for e in range(E):
        one = ti8.int8_matmul(x[e].contiguous(), q[e], s[e], p=p)
        one_t = ti8.int8_matmul_t(gr[e].contiguous(), q[e], s[e])
        assert torch.equal(got[e], one), e
        assert torch.equal(got_t[e], one_t), e


def test_moe_serving_on_the_card_matches_cpu(cuda):
    """qwen3-moe smoke (f32) on the card and on the CPU, the same codes:
    the slot scheduler (``make_scheduler("auto")``) gives equal greedy
    tokens; the card runs the batched kernels and no plain version."""
    import numpy as np
    from repro_torch.models import model_zoo
    from repro_torch.serve.params import quantize_leaf
    from repro_torch.serve.scheduler import Request, make_scheduler
    bundles = {dev: model_zoo.build_arch("qwen3-moe-30b-a3b", smoke=True,
                                         device=dev, dtype=torch.float32)
               for dev in ("cpu", "cuda")}
    gen = torch.Generator(device=cuda).manual_seed(0)
    p_gpu = bundles["cuda"].init_params(
        gen, leaf_fn=lambda _, t: quantize_leaf(t))

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        return t.to("cpu")

    params = {"cpu": to_cpu(p_gpu), "cuda": p_gpu}
    rng = np.random.default_rng(4)
    reqs = [(i, rng.integers(1, 512, size=int(rng.integers(3, 30)))
             .astype(np.int32).tolist(), int(rng.integers(2, 8)))
            for i in range(6)]
    out = {}
    for dev in ("cpu", "cuda"):
        sched = make_scheduler(bundles[dev], params[dev], num_slots=3,
                               max_len=48, dtype=torch.float32, device=dev)
        assert type(sched).__name__ == "Scheduler"
        LAUNCHES.clear()
        comps = sched.run([Request(*r) for r in reqs])
        out[dev] = ({c.rid: c.tokens for c in comps}, dict(LAUNCHES))
    (t_c, n_c), (t_g, n_g) = out["cpu"], out["cuda"]
    assert t_g == t_c
    assert n_g.get("int8_matmul_batched") and n_g.get("int8_matmul")
    assert not any(k.endswith("_ref") or k.startswith("deq_")
                   for k in n_g)
    assert n_c.get("deq_matmul_batched")


def test_int8_matmul_f32_x_slstm_gates(cuda):
    """xlstm-125m's sLSTM gate projection at f32 x and decode M 4 (four
    slots), K 768, N 3072: the small-M path's two passes within 1e-4 of
    max|plain|."""
    g = torch.Generator(device=cuda).manual_seed(768)
    qt = quant.quantize_blockwise(torch.randn((768, 3072), generator=g,
                                              device=cuda) * 0.02, 8,
                                  symmetric=True)
    x = torch.randn((4, 768), generator=g, device=cuda)
    assert ti8.plan(4, 768, 3072).path == 0
    LAUNCHES.clear()
    got = ti8.int8_matmul(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert LAUNCHES["int8_matmul"] == 1
    want = ref.int8_matmul_ref(x, qt.q, qt.scale, 256)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4


def test_xlstm_smoke_serves_on_the_card_matches_cpu(cuda):
    """xlstm-125m smoke (f32) on the card and on the CPU, the same codes:
    the slot scheduler gives equal greedy tokens, its pool keeps the
    states in float32, and the card runs the kernels and no plain
    version."""
    import numpy as np
    from repro_torch.models import model_zoo
    from repro_torch.serve.params import quantize_leaf
    from repro_torch.serve.scheduler import Request, make_scheduler
    bundles = {dev: model_zoo.build_arch("xlstm-125m", smoke=True,
                                         device=dev, dtype=torch.float32)
               for dev in ("cpu", "cuda")}
    gen = torch.Generator(device=cuda).manual_seed(0)
    p_gpu = bundles["cuda"].init_params(
        gen, leaf_fn=lambda _, t: quantize_leaf(t))

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        return t.to("cpu")

    params = {"cpu": to_cpu(p_gpu), "cuda": p_gpu}
    rng = np.random.default_rng(4)
    reqs = [(i, rng.integers(1, 512, size=int(rng.integers(3, 40)))
             .astype(np.int32).tolist(), int(rng.integers(2, 8)))
            for i in range(6)]
    out = {}
    for dev in ("cpu", "cuda"):
        sched = make_scheduler(bundles[dev], params[dev], num_slots=3,
                               max_len=48, dtype=torch.bfloat16, device=dev)
        assert type(sched).__name__ == "Scheduler"
        assert all(c.dtype == torch.float32
                   for c in sched.pool.caches["seg0_xlstm"])
        LAUNCHES.clear()
        comps = sched.run([Request(*r) for r in reqs])
        out[dev] = ({c.rid: c.tokens for c in comps}, dict(LAUNCHES))
    (t_c, n_c), (t_g, n_g) = out["cpu"], out["cuda"]
    assert t_g == t_c
    assert n_g.get("int8_matmul")
    assert not any(k.endswith("_ref") or k.startswith("deq_")
                   for k in n_g)
    assert n_c.get("deq_matmul")


@pytest.mark.parametrize("M", [4, 512])
def test_head_at_vocab_256206(cuda, M):
    """seamless-m4t-medium's head, W (1024, 256206), codes padded to
    256256: h (M, 1024) bf16 through ``ops.quantized_dense`` on a
    QVirtual (``int8_matmul``, the logits cropped to 256206 columns, a
    bf16 row stride that is no 16-byte multiple), then a cotangent of
    that width back through ``int8_matmul_t`` (the op pads g to 256256),
    each held against its plain version: one launch each, no plain
    version; the small-M path (M 4) within 5e-3 and the tiled path's one
    bf16 pass (M 512) within 2e-2 of max|plain| (both after the bf16
    cast of the output), ``dL/dx`` within 5e-3."""
    import torch.nn.functional as F
    V, D = 256206, 1024
    g = torch.Generator(device=cuda).manual_seed(26)
    qt = quant.quantize_blockwise(
        torch.randn((D, V), generator=g, device=cuda) * 0.03, 8,
        symmetric=True)
    assert tuple(qt.q.shape) == (D, 256256) and qt.orig_last == V
    x = torch.randn((M, D), generator=g, device=cuda).to(torch.bfloat16)
    x.requires_grad_(True)
    gy = torch.randn((M, V), generator=g, device=cuda).to(torch.bfloat16)
    LAUNCHES.clear()
    y = ops.quantized_dense(x, quant.virtualize(qt), dtype=torch.bfloat16)
    dx, = torch.autograd.grad(y, [x], gy)
    torch.cuda.synchronize()
    assert {k: n for k, n in LAUNCHES.items() if n} == {
        "int8_matmul": 1, "int8_matmul_t": 1}
    assert tuple(y.shape) == (M, V) and y.stride(0) * 2 % 16
    want_y = ref.int8_matmul_ref(x.detach(), qt.q, qt.scale, 256)
    assert (want_y[:, V:] == 0).all()
    tol = 5e-3 if ti8.plan(M, D, 256256).path == 0 else 2e-2
    assert _rel(y.float(), want_y[:, :V]) <= tol
    want_dx = ref.int8_matmul_t_ref(F.pad(gy, (0, 256256 - V)), qt.q,
                                    qt.scale, 256)
    assert torch.isfinite(dx).all()
    assert _rel(dx.float(), want_dx) <= 5e-3


def _leaves(t) -> list:
    """A parameter tree's tensors in key order (a QTensor's codes and
    scales)."""
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if hasattr(t, "q"):
        return [t.q, t.scale]
    return [t] if isinstance(t, torch.Tensor) else []


def test_recording_leaves_outputs_bit_equal(cuda):
    """``profile.recording()`` counts and changes nothing: two steps of the
    llama-60m smoke on the card (a refresh and a steady step) and one call
    of each other recorded op, run with and without a recording from the
    same state and inputs, give bit-equal outputs and equal launches; the
    recorded rows count those launches."""
    from repro_torch.config import QGaLoreConfig, TrainConfig
    from repro_torch.core.optimizers import preset
    from repro_torch.kernels import profile
    from repro_torch.models import model_zoo
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import Trainer

    qcfg = preset("qgalore", QGaLoreConfig(rank=8, min_dim=32,
                                           update_interval=4))
    tcfg = TrainConfig(seed=0, global_batch=4, seq_len=32, steps=2,
                       learning_rate=1e-2, warmup_steps=1, log_every=0)
    g = torch.Generator(device=cuda).manual_seed(27)
    w = quant.quantize_blockwise(torch.randn((512, 300), generator=g,
                                             device=cuda) * 0.02, 8,
                                 symmetric=True)
    P = projector.quantize_projection(
        torch.linalg.qr(torch.randn((300, 64), generator=g,
                                    device=cuda))[0], 4, 256)
    grad = torch.randn((512, 300), generator=g, device=cuda) * 1e-2
    u01 = torch.rand(w.q.shape, generator=g, device=cuda)
    q, kv = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
             for s in ((2, 130, 8, 64), (2, 130, 2, 64)))

    def run():
        bundle = model_zoo.build_arch("llama-60m", smoke=True,
                                      device=cuda.type, dtype=torch.float32)
        tr = Trainer(bundle, tcfg, qcfg,
                     state=step_lib.init_state(bundle, qcfg, seed=0))
        losses = [h["loss"] for h in tr.run()]
        new, m_new, v_new = ops.unfused_qgalore_update(
            w, grad, torch.zeros((512, 64), device=cuda),
            torch.zeros((512, 64), device=cuda), P, 1, 1e-3, u01,
            gscale=0.25)
        outs = [new.q, new.scale, m_new, v_new,
                ops.flash_attention(q, kv, kv),
                ops.quantize_int8(grad).q]
        torch.cuda.synchronize()
        return losses, outs + _leaves(tr.state.params)

    LAUNCHES.clear()
    plain_losses, plain = run()
    plain_launches = {k: n for k, n in LAUNCHES.items() if n}
    LAUNCHES.clear()
    profile.reset()
    with profile.recording():
        losses, outs = run()
    launches = {k: n for k, n in LAUNCHES.items() if n}
    assert losses == plain_losses
    assert launches == plain_launches
    assert len(outs) == len(plain)
    for a, b in zip(outs, plain):
        assert torch.equal(a, b)
    assert profile.launches_by_kernel(profile.snapshot()) == launches
    profile.reset()


# ---------------------------------------------------------------------------
# tensor and expert parallelism's shapes (chip_smoke.py phase 18)
# ---------------------------------------------------------------------------

# mistral-nemo-12b's slices a rank on the (1, 2) mesh, M = 8 x 256 tokens:
# wq (5120, 2048), wk / wv (5120, 512), wo (2048, 5120), wi / wg (5120,
# 7168), wd (7168, 5120), the head's vocabulary half (5120, 65536)
TP_SLICES = [(5120, 2048), (5120, 512), (2048, 5120), (5120, 7168),
             (7168, 5120), (5120, 65536)]


@pytest.mark.parametrize("K,N", TP_SLICES)
def test_int8_matmul_at_tp_slices(cuda, K, N):
    """Both INT8 matmuls at the slices, bf16 rows: the forward within 2e-2
    of max|plain| (one tensor-core pass), ``dL/dx`` within 1e-4 (bf16 g is
    exact in its products)."""
    M = 2048
    g = torch.Generator(device=cuda).manual_seed(K + N)
    qt = quant.quantize_blockwise(torch.randn((K, N), generator=g,
                                              device=cuda) * 0.02, 8,
                                  symmetric=True)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    go = torch.randn((M, N), generator=g, device=cuda).to(torch.bfloat16)
    LAUNCHES.clear()
    got = ti8.int8_matmul(x, qt.q, qt.scale)
    got_t = ti8.int8_matmul_t(go, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert LAUNCHES["int8_matmul"] == LAUNCHES["int8_matmul_t"] == 1
    assert _rel(got, ref.int8_matmul_ref(x, qt.q, qt.scale, 256)) <= 2e-2
    assert _rel(got_t, ref.int8_matmul_t_ref(go, qt.q, qt.scale, 256)) \
        <= 1e-4


# the fused update at each slice's GaLore state, rank 1024: a slice on the
# contracted dim takes its d-slice of P and the whole low-rank gradient,
# one on the surviving dim the whole P and its slice of the gradient
FUSED_TP = [(5120, 2048, 1024, "right"), (5120, 512, 1024, "right"),
            (2048, 5120, 1024, "left"), (5120, 7168, 1024, "left"),
            (7168, 5120, 1024, "right"), (5120, 65536, 1024, "left")]


@pytest.mark.parametrize("m,n,r,side", FUSED_TP)
def test_fused_update_at_tp_slices(cuda, m, n, r, side):
    qt, qp, low, m32, v32, u01 = _fused_problem(cuda, m, n, r, side, m + n)
    kw = dict(side=side, gscale=0.25, weight_decay=0.0)
    LAUNCHES.clear()
    got, mg, vg = ops.fused_qgalore_update(qt, low, m32, v32, qp, 3, 1e-2,
                                           u01, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_qgalore_update"] == 1
    cpu = lambda t: t.to("cpu")
    want, mw, vw = ops.fused_qgalore_update(
        qt.to("cpu"), cpu(low), cpu(m32), cpu(v32), qp.to("cpu"), 3, 1e-2,
        cpu(u01), **kw)
    quantum = want.scale.max().item()
    dq = (quant.dequantize(got.to("cpu"), torch.float32)
          - quant.dequantize(want, torch.float32)).abs().max().item()
    assert dq <= quantum + 1e-6
    assert (got.q.cpu() == want.q)[:, :n].float().mean().item() > 0.999
    for a, b in ((got.scale, want.scale), (mg, mw), (vg, vw)):
        assert _rel(a.cpu(), b) <= 1e-5


@pytest.mark.parametrize("K,N", [(2048, 768), (768, 2048)])
def test_batched_kernels_at_ep_experts(cuda, K, N):
    """The batched pair at an expert-parallel rank's buffers: 64 of
    qwen3-moe-30b-a3b's 128 experts, 2 ranks x 512 rows, bf16."""
    E, M = 64, 1024
    qt, x, gr = _batched_case(cuda, E, M, K, N, torch.bfloat16, K + 3)
    LAUNCHES.clear()
    got = ti8.int8_matmul_batched(x, qt.q, qt.scale)
    got_t = ti8.int8_matmul_t_batched(gr, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert LAUNCHES["int8_matmul_batched"] == 1
    assert LAUNCHES["int8_matmul_t_batched"] == 1
    want = ref.int8_matmul_batched_ref(x, qt.q, qt.scale, 256)
    want_t = ref.int8_matmul_t_batched_ref(gr, qt.q, qt.scale, 256)
    two_pass = ti8.plan(M, K, qt.q.shape[-1], E=E).path == 0
    assert _rel(got, want) <= (1e-4 if two_pass else 2e-2)
    assert _rel(got_t, want_t) <= 1e-4


def test_tensor_and_expert_parallel_ranks_on_one_card(cuda, tmp_path):
    """Two ranks on cuda:0 over gloo: the tensor-parallel test model on the
    (1, 2) mesh and the MoE's smoke config expert-parallel, against one
    process on the card (tensor-parallel: the trajectory within the
    reference's band, 2e-3; expert-parallel: step 0 within 1e-3, where
    only the per-rank aux loss differs, and finite losses after), every
    kernel launched in both ranks and no plain version."""
    import numpy as np

    import torch_tp_ranks as tr
    from repro_torch.distributed.spawn import run_ranks
    one_tp = tr.card_run(None, "tp")
    one_ep = tr.card_run(None, "ep")
    two = run_ranks(tr.card_runs, 2, backend="gloo",
                    rendezvous_dir=str(tmp_path))
    for r in two:
        np.testing.assert_allclose(r["tp"]["losses"], one_tp["losses"],
                                   rtol=2e-3)
        assert abs(r["ep"]["losses"][0] - one_ep["losses"][0]) <= \
            1e-3 * one_ep["losses"][0]
        assert np.isfinite(r["ep"]["losses"]).all()
        for run in (r["tp"], r["ep"]):
            assert run["launches"].get("fused_qgalore_update", 0) > 0
            for name in ("int8_matmul_ref", "int8_matmul_t_ref",
                         "fused_qgalore_update_ref", "deq_matmul",
                         "deq_matmul_t", "deq_matmul_batched"):
                assert run["launches"].get(name, 0) == 0, name
    assert two[0]["tp"]["losses"] == two[1]["tp"]["losses"]
    assert two[0]["ep"]["losses"] == two[1]["ep"]["losses"]
