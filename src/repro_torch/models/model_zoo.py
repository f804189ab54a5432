"""Architecture registry of the port: the dense decoder-only family (the
LLaMA configs, mistral-nemo-12b, yi-9b, qwen3-32b, gemma-7b), the VLM
backbone internvl2-2b, the mixture of experts qwen3-moe-30b-a3b,
deepseek-v3-671b (MLA, shared experts, leading dense layers, multi-token
prediction), the recurrent xlstm-125m (mLSTM and sLSTM blocks,
``models/xlstm_model.py``), the SSM hybrid zamba2-2.7b (Mamba2 blocks
and a shared attention block, ``models/zamba.py``) and the
encoder-decoder seamless-m4t-medium (``models/encdec.py``): every
architecture of the JAX package. A family ``ssm`` is unknown, as in the
JAX package."""
from __future__ import annotations

import importlib
import math
from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.base import ModelBundle

ARCH_IDS = ("llama-60m", "llama-130m", "llama-350m", "llama-1b",
            "llama-7b", "mistral-nemo-12b", "yi-9b", "qwen3-32b",
            "gemma-7b", "internvl2-2b", "qwen3-moe-30b-a3b",
            "deepseek-v3-671b", "xlstm-125m", "zamba2-2.7b",
            "seamless-m4t-medium")

FLASH_MAX_HEAD_DIM = 128    # csrc/flash_attention.cu takes d <= 128


def qk_width(cfg: ModelConfig) -> int:
    """The width of a query and key head: ``qk_nope_head_dim +
    qk_rope_head_dim`` for MLA, else the head dim."""
    if cfg.attention == "mla":
        return cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
    return cfg.resolved_head_dim


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise ValueError(f"{arch_id!r} is not ported; the port has "
                         f"{', '.join(ARCH_IDS)}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.smoke_config() if smoke else mod.CONFIG


def check_config(cfg: ModelConfig) -> None:
    """Raise for any part of ``cfg`` the port does not have. Other
    families than ``dense``, ``vlm``, ``moe``, ``xlstm``, ``hybrid`` and
    ``encdec`` raise the JAX package's ``ValueError`` (``unknown family
    ssm``), and so do an ``xlstm`` config without ``cfg.xlstm`` and a
    ``hybrid`` one without ``cfg.ssm`` and ``cfg.hybrid``. qk-norm, GeGLU,
    tied embeddings, the VLM prefix, a mixture of experts (``cfg.moe``,
    with shared experts and leading dense layers), MLA (``attention ==
    "mla"`` with ``cfg.mla``), multi-token prediction at ``mtp_depth`` 1
    and the encoder-decoder are ported.

    ``mtp_depth`` above 1 is refused by name: the JAX package builds one
    MTP block whatever the depth, so the port would compute depth 1 under
    another number (ROADMAP queue 3, a deviation by design). So is a
    nonzero ``xlstm.mlstm_head_dim``: the JAX package always splits the
    mLSTM's inner width evenly over the heads, whatever the field says."""
    if cfg.family not in ("dense", "vlm", "moe", "xlstm", "hybrid",
                          "encdec"):
        raise ValueError(f"{cfg.name}: unknown family {cfg.family}")
    if cfg.family == "hybrid" and (cfg.ssm is None or cfg.hybrid is None):
        raise ValueError(f"{cfg.name}: family 'hybrid' needs cfg.ssm and "
                         "cfg.hybrid")
    if cfg.family == "xlstm":
        if cfg.xlstm is None:
            raise ValueError(f"{cfg.name}: family 'xlstm' needs cfg.xlstm")
        if cfg.xlstm.mlstm_head_dim:
            raise NotImplementedError(
                f"{cfg.name}: mlstm_head_dim {cfg.xlstm.mlstm_head_dim} is "
                "refused: the JAX package splits the mLSTM's inner width "
                "over the heads whatever it says (ROADMAP queue 3); use "
                "mlstm_head_dim 0")
        return
    if cfg.attention not in ("gqa", "mla"):
        raise ValueError(f"{cfg.name}: unknown attention {cfg.attention!r}")
    if cfg.attention == "mla" and cfg.mla is None:
        raise ValueError(f"{cfg.name}: attention 'mla' needs cfg.mla")
    if cfg.mtp_depth > 1:
        raise NotImplementedError(
            f"{cfg.name}: mtp_depth {cfg.mtp_depth} is refused: the JAX "
            "package builds one MTP block whatever the depth (ROADMAP "
            "queue 3); use mtp_depth 1")
    if cfg.ffn_activation not in ("silu", "gelu"):
        raise ValueError(f"{cfg.name}: unknown FFN activation "
                         f"{cfg.ffn_activation!r}")


TP_FOLLOW_UP = "ROADMAP queue 1, 5b follow-up: TP for the other families"


def check_parallel(cfg: ModelConfig, tp_group=None, ep_group=None) -> None:
    """Raise for a parallel layout the port does not have. Tensor
    parallelism (a model group above one rank) covers the dense GQA
    decoders (the LLaMA configs, mistral-nemo-12b, yi-9b, qwen3-32b,
    internvl2-2b as text); gemma-7b's tied head (it contracts over the d
    the rules split) and the MoE, MLA, xLSTM, hybrid and encoder-decoder
    families are refused by name. Expert parallelism needs an MoE whose
    experts the group divides."""
    if tp_group is not None and tp_group.world > 1:
        why = None
        if cfg.family not in ("dense", "vlm") or cfg.moe is not None:
            why = f"family {cfg.family}" + (" (MoE)" if cfg.moe else "")
        elif cfg.attention != "gqa":
            why = f"attention {cfg.attention}"
        elif cfg.tie_embeddings:
            why = "the tied head, which contracts over the d the rules split"
        elif cfg.mtp_depth:
            why = "multi-token prediction"
        if why:
            raise NotImplementedError(
                f"{cfg.name}: tensor parallelism over {tp_group.world} ranks "
                f"does not cover {why} ({TP_FOLLOW_UP})")
    if ep_group is not None:
        if cfg.moe is None:
            raise ValueError(f"{cfg.name}: expert parallelism needs an MoE "
                             "config")
        if cfg.moe.num_experts % ep_group.world:
            raise ValueError(f"{cfg.name}: {cfg.moe.num_experts} experts do "
                             f"not split over {ep_group.world} ranks")


def build(cfg: ModelConfig, *, device=None, dtype=torch.bfloat16,
          flash_attention: bool = False, split_layers: int = 0,
          tp_group=None, ep_group=None) -> ModelBundle:
    """Bundle for ``cfg`` on ``device`` (default ``cuda``, which must be
    present). ``flash_attention`` routes prefill attention through the
    flash kernel (the JAX package's ``REPRO_FLASH_ATTENTION=1``), which
    takes head widths up to 128 only: a wider head (gemma-7b's 256, MLA's
    query and key width 192) is refused here, never sent to the einsum
    path in silence;
    ``split_layers`` splits the block stack into two segments
    (``transformer.build``). The xLSTM family (``xlstm_model.build``) has
    neither: it has no attention for the flag to route, and the JAX
    package refuses to split it. The hybrid (``zamba.build``) takes the
    flag for its sites' attention and the encoder-decoder
    (``encdec.build``) for its decoder's self-attention; as the JAX
    package, both refuse a split. ``tp_group`` / ``ep_group`` (a
    ``Comm``): tensor or expert parallelism (:func:`check_parallel`,
    ``transformer.build``)."""
    check_config(cfg)
    check_parallel(cfg, tp_group, ep_group)
    if tp_group is not None and tp_group.world == 1:
        tp_group = None
    if split_layers and cfg.family in ("xlstm", "hybrid", "encdec"):
        raise ValueError(f"split_layers unsupported for family {cfg.family}")
    if cfg.family == "xlstm":
        if flash_attention:
            raise ValueError(f"{cfg.name}: flash_attention routes attention, "
                             "and the xlstm family has none")
        from repro_torch.models import xlstm_model
        return xlstm_model.build(cfg, device=resolve_device(device),
                                 dtype=dtype)
    if flash_attention and qk_width(cfg) > FLASH_MAX_HEAD_DIM:
        what = ("MLA's query and key width (qk_nope_head_dim + "
                "qk_rope_head_dim)" if cfg.attention == "mla" else "head_dim")
        raise NotImplementedError(
            f"{cfg.name}: the flash kernel takes head_dim <= "
            f"{FLASH_MAX_HEAD_DIM}; {what} is {qk_width(cfg)} "
            "(ROADMAP queue 2 #4: flash d > 128)")
    if cfg.family == "hybrid":
        from repro_torch.models import zamba
        return zamba.build(cfg, device=resolve_device(device), dtype=dtype,
                           flash_attention=flash_attention)
    if cfg.family == "encdec":
        from repro_torch.models import encdec
        return encdec.build(cfg, device=resolve_device(device), dtype=dtype,
                            flash_attention=flash_attention)
    from repro_torch.models import transformer
    return transformer.build(cfg, device=resolve_device(device), dtype=dtype,
                             flash_attention=flash_attention,
                             split_layers=split_layers, tp_group=tp_group,
                             ep_group=ep_group)


def build_arch(arch_id: str, smoke: bool = False,
               device: Optional[str] = None, **kw) -> ModelBundle:
    return build(get_config(arch_id, smoke=smoke), device=device, **kw)


def count_params(cfg: ModelConfig) -> int:
    """Total parameters of ``cfg`` (the MTP block, norm and projection
    included), drawn on the meta device (nothing is allocated): the
    counterpart of ``count_params_analytic``."""
    bundle = build(cfg, device="meta", dtype=torch.float32)
    params = bundle.init_params(torch.Generator())

    def total(t):
        if isinstance(t, dict):
            return sum(total(v) for v in t.values())
        return math.prod(t.shape)

    return total(params)


def count_active_params(cfg: ModelConfig) -> int:
    """Parameters a token reads (the MoE: only its top-k and the shared
    experts), the counterpart of ``repro/models/model_zoo.py:68``."""
    total = count_params(cfg)
    if cfg.moe is None or not cfg.moe.num_experts:
        return total
    mc = cfg.moe
    per_expert = 3 * cfg.d_model * mc.expert_ff       # wi, wg, wd
    n_moe_layers = cfg.num_layers - mc.first_dense_layers
    return total - n_moe_layers * (mc.num_experts - mc.top_k) * per_expert
