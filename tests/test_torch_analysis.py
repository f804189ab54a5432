"""The port's analysis tools against the JAX package's: the analytic FLOPs
and bytes of every architecture over its shape cells and the smoke's own
cells equal the reference's; ``kernel_bound`` on the profile's counts
gives the llama-1b bounds ``PERF.md`` quotes; ``peaks`` knows only the
H100; the report renders."""
import json

import pytest

from repro import config as jconfig
from repro.analysis import analytic as janalytic
from repro.models import model_zoo as jzoo
from repro_torch import config as tconfig
from repro_torch.analysis import analytic, report, roofline
from repro_torch.config import ShapeCell
from repro_torch.kernels import profile
from repro_torch.models import model_zoo
from torch_one_thread import one_thread  # noqa: F401

# the cells chip_smoke.py times: llama-1b's training step (8 x 256) and
# decode (8 rows at 512), 4 x 512 training (phases 14c-16d), 4-slot decode
# at 528 (phase 11a), and a prefill
SMOKE_CELLS = (ShapeCell("smoke_train", 256, 8, "train"),
               ShapeCell("smoke_train_4x512", 512, 4, "train"),
               ShapeCell("smoke_decode", 512, 8, "decode"),
               ShapeCell("smoke_decode_4", 528, 4, "decode"),
               ShapeCell("smoke_prefill", 512, 4, "prefill"))


@pytest.fixture(scope="module")
def ref_counts():
    """The reference's parameter count memoized by config for this file
    (an exact abstract count, ~0.2 s a call, which every analytic function
    repeats)."""
    mp = pytest.MonkeyPatch()
    count, memo = jzoo.count_params_analytic, {}

    def cached(cfg):
        if repr(cfg) not in memo:
            memo[repr(cfg)] = count(cfg)
        return memo[repr(cfg)]

    mp.setattr(jzoo, "count_params_analytic", cached)
    yield
    mp.undo()


def _close(got, want):
    assert got == pytest.approx(want, rel=1e-12, abs=0.0)


def test_shape_cells_match_the_reference():
    as_t = lambda cells: [(c.name, c.seq_len, c.global_batch, c.kind)
                          for c in cells]
    assert as_t(tconfig.SHAPE_CELLS) == as_t(jconfig.SHAPE_CELLS)
    assert tconfig.LONG_CONTEXT_ARCHS == jconfig.LONG_CONTEXT_ARCHS
    for arch in model_zoo.ARCH_IDS:
        assert as_t(tconfig.cells_for_arch(arch)) == \
            as_t(jconfig.cells_for_arch(arch))


@pytest.mark.parametrize("arch", model_zoo.ARCH_IDS)
def test_analytic_matches_the_reference(ref_counts, arch):
    cfg, jcfg = model_zoo.get_config(arch), jzoo.get_config(arch)
    assert model_zoo.count_params(cfg) == jzoo.count_params_analytic(jcfg)
    assert model_zoo.count_active_params(cfg) == \
        jzoo.count_active_params(jcfg)
    for cell in tconfig.cells_for_arch(arch) + SMOKE_CELLS:
        jcell = jconfig.ShapeCell(cell.name, cell.seq_len,
                                  cell.global_batch, cell.kind)
        for ctx in (cell.seq_len, cell.seq_len // 2):
            _close(analytic.forward_flops_per_token(cfg, ctx),
                   janalytic.forward_flops_per_token(jcfg, ctx))
        _close(analytic.model_flops(cfg, cell),
               janalytic.model_flops(jcfg, jcell))
        for rank in (128, 512):
            _close(analytic.cell_flops(cfg, cell, rank),
                   janalytic.cell_flops(jcfg, jcell, rank))
            _close(analytic.cell_bytes(cfg, cell, rank=rank),
                   janalytic.cell_bytes(jcfg, jcell, rank=rank))
        _close(analytic.galore_projection_flops(cfg),
               janalytic.galore_projection_flops(jcfg))


# llama-1b: 24 layers of wq, wk, wv, wo, w_gate, w_up, w_down and the head,
# as (K, N) with N padded to the 256 block
_LAYER = [(2048, 2048)] * 4 + [(2048, 5461)] * 2 + [(5461, 2048)]
_WEIGHTS = _LAYER * 24 + [(2048, 32000)]


def _pad(n):
    return -(-n // 256) * 256


def _bound(cost, peak="bf16"):
    return roofline.kernel_bound(*cost, peak)


def _fused(m, n, r=512):
    """The kernel's operands as ``ops.fused_qgalore_update`` pads them."""
    n_pad = _pad(n)
    if m >= n:      # right: P (n, r) rows padded to n_pad
        low, pq, ps = m * r, n_pad * r // 2, n_pad * (r // 256)
    else:           # left: the triple's columns padded to n_pad
        low, pq, ps = r * n_pad, m * r // 2, m * (r // 256)
    q = m * n_pad
    return (2 * m * n_pad * r,
            profile.fused_update_bytes(low, pq, ps, q, q // 256, q))


BOUNDS = {
    # PERF.md §6 kernel table: the printed digits, and how each was summed
    "int8_matmul decode": (0.398, 3, lambda: sum(
        _bound(profile.int8_matmul_cost(8, K, _pad(N), 2))[0]
        for K, N in _WEIGHTS)),
    "int8_matmul training": (10.42, 2, lambda: sum(
        _bound(profile.int8_matmul_cost(2048, K, _pad(N), 2))[0]
        for K, N in _WEIGHTS + _LAYER * 24)),
    "int8_matmul_t training": (5.34, 2, lambda: sum(
        _bound(profile.int8_matmul_t_cost(2048, K, _pad(N), 2))[0]
        for K, N in _WEIGHTS)),
    "fused_qgalore_update": (4.28, 2, lambda: sum(
        _bound(_fused(m, n))[0] for m, n in _WEIGHTS)),
    "flash_attention prefill": (0.481, 3, lambda: 24 * _bound(
        profile.flash_cost(8, 512, 32, 32, 64, 64, True, 2))[0]),
    "sr_requant": (0.0460, 4, lambda: sum(
        roofline.kernel_bound(0, profile.sr_requant_bytes(m, n))[0]
        for m, n in ((2048, 2048), (5461, 2048)))),
    "int4_matmul": (0.0233, 4, lambda: sum(
        _bound(profile.int4_matmul_cost(m, n, 512, 256, 4))[0]
        for m, n in ((2048, 2048), (5461, 2048)))),
    "blockwise_quant": (1.932, 3, lambda: sum(
        roofline.kernel_bound(0, profile.blockwise_quant_bytes(K, _pad(N)))[0]
        for K, N in _WEIGHTS)),
}


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_kernel_bound_gives_perf_md_bounds(name):
    printed, digits, fn = BOUNDS[name]
    assert round(fn(), digits) == printed


def test_kernel_bound_names_what_bounds_it():
    assert roofline.kernel_bound(0, 3.35e9) == (1.0, "bytes")
    ms, by = roofline.kernel_bound(989e9, 1.0)
    assert by == "operations" and ms == pytest.approx(1.0)
    # the f32 rate is 989 / 67 of the bf16 one
    assert roofline.kernel_bound(67e9, 1.0, "f32")[0] == pytest.approx(1.0)


def test_peaks_know_only_the_h100():
    assert roofline.peaks("NVIDIA H100 80GB HBM3") == roofline.PEAKS
    for name in ("NVIDIA A100-SXM4-80GB", "TPU v5e", ""):
        with pytest.raises(ValueError, match="no peak rates"):
            roofline.peaks(name)


def test_roofline_of_llama_1b_steps():
    """The issue's predictions: llama-1b's training step at rank 512 and
    its 8-row decode step, against PERF.md §5's times."""
    cfg = model_zoo.get_config("llama-1b")
    tr = roofline.Roofline.for_step(cfg, SMOKE_CELLS[0], 0.6219, rank=512)
    assert tr.model_flops == pytest.approx(1.645e13, rel=1e-3)
    assert tr.flops == pytest.approx(2.328e13, rel=1e-3)
    assert tr.useful_flops_ratio == pytest.approx(0.707, abs=1e-3)
    assert tr.mfu == pytest.approx(0.027, abs=5e-4)
    assert tr.dominant == "compute" and tr.collective_s == 0.0
    assert tr.mfu_bound == pytest.approx(tr.mfu / tr.share)
    dec = roofline.Roofline.for_step(cfg, SMOKE_CELLS[2], 0.04415)
    assert dec.nbytes == pytest.approx(2.95e9, rel=1e-3)
    assert dec.dominant == "memory"
    assert dec.bound_s == pytest.approx(0.88e-3, rel=1e-2)
    assert dec.share == pytest.approx(0.02, abs=1e-3)
    assert roofline.serving_mfu(cfg, 100.0) == pytest.approx(
        100.0 * 2 * model_zoo.count_params(cfg) / 989e12)


def test_report_renders(tmp_path, capsys):
    cfg = model_zoo.get_config("llama-1b")
    steps = (("train", SMOKE_CELLS[0], 0.62),
             ("decode", SMOKE_CELLS[2], 0.044))
    rows = [dict(name=n, **roofline.Roofline.for_step(
        cfg, c, s, rank=512).row()) for n, c, s in steps]
    table = report.roofline_table(rows)
    assert table.count("\n") == 3 and "**compute**" in table
    snap = {"quantized_dense/fwd": {
        "calls": 337, "bytes": 10**9, "flops": 10**13,
        "kernel": "int8_matmul", "peak": "bf16"},
        "quantized_dense_batched/fwd": {
            "calls": 2, "bytes": 10**6, "flops": 10**9,
            "kernel": "int8_matmul_batched", "peak": "bf16"},
        "sr_requant_update": {"calls": 1, "bytes": 10**8, "flops": 0,
                              "kernel": "sr_requant", "peak": None}}
    krows = report.kernel_rows(snap, {"int8_matmul": 20.0})
    assert [r["kernel"] for r in krows] == ["int8_matmul", "sr_requant"]
    assert krows[0]["calls"] == 339 and krows[0]["bound_by"] == "operations"
    assert krows[0]["share"] == pytest.approx(krows[0]["bound_ms"] / 20.0)
    assert krows[1]["share"] is None and krows[1]["bound_by"] == "bytes"
    kt = report.kernel_table(snap, {"int8_matmul": 20.0})
    assert "not measured" in kt and "(bf16 peak)" in kt
    slower = [dict(r, measured_s=2 * r["measured_s"], mfu=r["mfu"] / 2,
                   share=r["share"] / 2) for r in rows]
    cmp = report.compare(rows, slower)
    assert "+100.0%" in cmp and "-50.0%" in cmp
    path = tmp_path / "rows.json"
    path.write_text(json.dumps({"roofline": rows, "kernels": {
        "step": {"snapshot": snap, "device_ms": {"int8_matmul": 20.0}}}}))
    assert report.main([str(path), "--base", str(path)]) == 0
    out = capsys.readouterr().out
    assert "## Roofline" in out and "## Kernels: step" in out
    assert "## Base against new" in out
