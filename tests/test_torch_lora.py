"""The port's LoRA / QLoRA / factorized baselines (``models/lora.py``)
against the JAX package's on llama-60m smoke split after one layer: the
adapters' keys, shapes and distributions, ``merge`` on an INT8 and a
float base in both modes, ``adapter_nbytes``, and the QLoRA loss through
``merge`` and the bundle's loss with its gradients with respect to A and
B. The base weights come from the port's init and the adapters from the
JAX package's draws (B made non-zero), handed over through numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import base as jbase
from repro.models import lora as jlora
from repro.models import model_zoo as jzoo
from repro_torch.config import ShapeCell
from repro_torch.core import qgalore, quant
from repro_torch.core.optimizers import preset
from repro_torch.data.synthetic import batch_for_bundle
from repro_torch.models import base, lora, model_zoo
from repro_torch.train import step

from test_torch_train import _tcfg
from test_torch_transform import to_jax

RANK = 4


@pytest.fixture(scope="module")
def bases():
    """Both bundles and the port's weights, INT8 (``qgalore``) and float
    (``galore``: no weight quantization)."""
    tb = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                              dtype=torch.float32, split_layers=1)
    jb = jzoo.build_arch("llama-60m", smoke=True, dtype=jnp.float32,
                         split_layers=1)
    out = {}
    for name, method in (("int8", "qgalore"), ("float", "galore")):
        qcfg = preset(method, _tcfg())
        out[name] = step.init_state(tb, qcfg, seed=2).params
    return tb, jb, out


def _jax_adapters(jparams, mode):
    """The reference's adapters as numpy, LoRA's B redrawn non-zero so
    that the adapter product is tested."""
    ad = jlora.init_adapters(jparams, RANK, jax.random.PRNGKey(5), mode=mode)
    rng = np.random.default_rng(7)
    out = {}
    for path, pair in ad.items():
        pair = {k: np.array(v) for k, v in pair.items()}
        if mode == "lora":
            pair["B"] = rng.standard_normal(pair["B"].shape).astype(
                np.float32) * 0.1
        out[path] = pair
    return out


@pytest.mark.parametrize("mode", ["lora", "factorized"])
def test_init_adapters_keys_shapes_and_draws(bases, mode):
    """The same keys (the reference's ``keystr`` paths) and shapes; float32
    on the leaf's device; B zero, the normal draws at the reference's
    scale (1 / sqrt(m), V: 1 / sqrt(r))."""
    _, _, params = bases
    got = lora.init_adapters(params["int8"], RANK,
                             torch.Generator().manual_seed(0), mode=mode)
    want = jlora.init_adapters(to_jax(params["int8"]), RANK,
                               jax.random.PRNGKey(0), mode=mode)
    assert list(got) == sorted(want) and len(got) == 14
    for path, pair in want.items():
        assert sorted(got[path]) == sorted(pair)
        for k, v in pair.items():
            t = got[path][k]
            assert tuple(t.shape) == tuple(v.shape), (path, k)
            assert t.dtype == torch.float32 and t.device.type == "cpu"
    for path, pair in got.items():
        first = "A" if mode == "lora" else "U"
        m = pair[first].shape[-2]
        assert float(pair[first].std() * m ** 0.5) == pytest.approx(1.0,
                                                                    abs=0.3)
        if mode == "lora":
            assert not pair["B"].any()
        else:
            r = pair["V"].shape[-2]
            assert float(pair["V"].std() * r ** 0.5) == pytest.approx(
                1.0, abs=0.3)
    assert not any(k in p.lower() for p in got
                   for k in ("embed", "head", "norm"))


@pytest.mark.parametrize("base_kind", ["int8", "float"])
@pytest.mark.parametrize("mode", ["lora", "factorized"])
def test_merge_matches_jax(bases, mode, base_kind):
    """``merge`` leaf by leaf within 1e-6 of max|ref| (the dequantized
    base, plus ``(alpha / r) A @ B`` broadcast over the layer stack, or
    ``U @ V``)."""
    _, _, params = bases
    tp = params[base_kind]
    ad_np = _jax_adapters(to_jax(tp), mode)
    want = jlora.merge(to_jax(tp), {p: {k: jnp.asarray(v)
                                        for k, v in d.items()}
                                    for p, d in ad_np.items()},
                       alpha=16.0, rank=RANK, mode=mode)
    got = lora.merge(tp, {p: {k: torch.from_numpy(v) for k, v in d.items()}
                          for p, d in ad_np.items()},
                     alpha=16.0, rank=RANK, mode=mode)
    flat_w = jax.tree_util.tree_leaves(want)
    flat_g = [l for _, l in qgalore.flatten(got)]
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        assert not isinstance(g, quant.QTensor)
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= 1e-6


def test_adapter_nbytes_matches_jax(bases):
    _, _, params = bases
    for mode in ("lora", "factorized"):
        got = lora.adapter_nbytes(lora.init_adapters(
            params["int8"], 8, torch.Generator().manual_seed(0), mode=mode))
        want = jlora.adapter_nbytes(jlora.init_adapters(
            to_jax(params["int8"]), 8, jax.random.PRNGKey(0), mode=mode))
        assert got == want > 0


def test_qlora_loss_and_grads_match_jax(bases):
    """The QLoRA loss (INT8 base, merged adapters, the bundle's plain
    loss) within 1e-5 relative, and its gradients with respect to every A
    and B within 1e-4 of max|ref| a tensor."""
    tb, jb, params = bases
    tp = params["int8"]
    jp = to_jax(tp)
    ad_np = _jax_adapters(jp, "lora")
    batch = batch_for_bundle(tb, ShapeCell("q", 16, 2, "train"), 0, 3)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    def jloss(ad):
        return jbase.loss_fn(jb, jlora.merge(jp, ad, rank=RANK), jbatch)[0]

    jl, jgrads = jax.value_and_grad(jloss)(
        {p: {k: jnp.asarray(v) for k, v in d.items()}
         for p, d in ad_np.items()})
    ad = {p: {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in d.items()} for p, d in ad_np.items()}
    leaves = [t for d in ad.values() for t in d.values()]
    with torch.enable_grad():
        tl, _ = base.loss_fn(tb, lora.merge(tp, ad, rank=RANK), batch)
        grads = torch.autograd.grad(tl, leaves)
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    i = 0
    for path, d in ad.items():
        for k in d:
            want = np.asarray(jgrads[path][k])
            got = grads[i].numpy()
            i += 1
            assert np.abs(want).max() > 0, (path, k)
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), \
                (path, k)
