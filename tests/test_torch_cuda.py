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
