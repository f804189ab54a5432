"""The port's model layers against the JAX package's: query-chunked
attention with a ragged last chunk, and the full-sequence forward of the
dense decoder (every position's logits) on the same INT8 codes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import QGaLoreConfig
from repro.models import attention as jattn
from repro.models import base as jbase
from repro.models import model_zoo as jzoo
from repro.models.transformer import _head_logits as j_head
from repro.train import step as jstep
from repro_torch.models import attention, base, model_zoo
from repro_torch.models.transformer import _head_logits as t_head
from repro_torch.serve import engine
from repro_torch.serve.params import from_jax_params

from test_torch_serve import _to_numpy


@pytest.mark.parametrize("Sq,q_chunk,H,KH", [(10, 4, 4, 2), (8, 8, 2, 2),
                                             (9, 3, 4, 1)])
def test_chunked_attention_matches(Sq, q_chunk, H, KH):
    rng = np.random.default_rng(Sq)
    q = rng.standard_normal((2, Sq, H, 16)).astype(np.float32)
    k = rng.standard_normal((2, Sq, KH, 16)).astype(np.float32)
    v = rng.standard_normal((2, Sq, KH, 16)).astype(np.float32)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   q_chunk=q_chunk)
    got = attention.chunked_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), causal=True,
                                      q_chunk=q_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_full_forward_logits_match_and_agree_with_prefill():
    jb = jzoo.build_arch("llama-60m", smoke=True, dtype=jnp.float32)
    jp = jstep.prepare_params(jb.init_params(jax.random.PRNGKey(1)),
                              QGaLoreConfig(), jnp.float32)
    tb = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                              dtype=torch.float32)
    tp = from_jax_params(_to_numpy(jp), device="cpu")
    toks = np.random.default_rng(3).integers(1, 512, size=(2, 12)) \
        .astype(np.int32)

    carry, ctx = jb.embed(jp, {"tokens": jnp.asarray(toks)})
    carry = jbase.run_segments(jb, jp, carry, ctx)
    want = j_head(jp, carry["h"], jb.cfg, jnp.float32)

    with torch.no_grad():
        tcarry, tctx = tb.embed(tp, {"tokens": torch.from_numpy(toks)})
        tcarry = base.run_segments(tb, tp, tcarry, tctx)
        got = t_head(tp, tcarry["h"], tb.cfg, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # the serving prefill's last-position logits are the forward's
    last, _ = engine.build_prefill(tb, 16)(tp, {"tokens":
                                                torch.from_numpy(toks)})
    np.testing.assert_allclose(last[:, 0].numpy(), got[:, -1].numpy(),
                               rtol=1e-5, atol=1e-5)
