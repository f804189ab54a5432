"""Model configuration for the PyTorch port.

A copy of the model, Q-GaLore, training and shape-cell dataclasses of
``repro/config.py`` (the port imports nothing from ``repro``), without
the fields of what is not ported (remat, LoRA, the JAX package's
execution switches but ``fused_update``). Every
ported architecture provides a module in ``repro_torch.configs`` exposing
``CONFIG`` (full size) and ``smoke_config()`` (reduced, CPU-runnable).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (None ⇒ dense FFN)."""
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    expert_ff: int = 0              # per-expert intermediate size
    router_aux_coef: float = 0.001  # load-balancing auxiliary loss
    # First N layers stay dense (DeepSeek-V3 uses 3 dense layers).
    first_dense_layers: int = 0
    dense_ff: int = 0               # intermediate size of the dense layers


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD settings."""
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk_size: int = 256


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block settings."""
    slstm_every: int = 6        # every Nth block is an sLSTM; others mLSTM
    mlstm_head_dim: int = 0     # 0 ⇒ d_model // num_heads
    proj_factor: float = 2.0    # mLSTM up-projection factor
    chunk_size: int = 256       # chunkwise-parallel training chunk


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: SSM backbone + shared attention block."""
    attn_every: int = 6         # shared transformer block applied every N layers
    shared_lora_rank: int = 64  # per-invocation LoRA on the shared block


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"       # dense | moe | ssm | xlstm | hybrid | encdec | vlm
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    num_kv_heads: int = 12
    head_dim: int = 0           # 0 ⇒ d_model // num_heads
    d_ff: int = 3072
    vocab_size: int = 32000
    max_seq_len: int = 8192
    # activation / norm details
    ffn_activation: str = "silu"   # silu (SwiGLU) | gelu (GeGLU)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rmsnorm_eps: float = 1e-5
    tie_embeddings: bool = False
    # scale token embeddings by sqrt(d_model) (gemma; the JAX package keys
    # this on the config's name)
    embed_scale: bool = False
    # attention flavor
    attention: str = "gqa"         # gqa | mla
    mla: Optional[MLAConfig] = None
    # family-specific
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # enc-dec
    num_encoder_layers: int = 0
    # vlm / audio frontend stubs: number of prefix embedding positions fed by
    # the (stubbed) modality encoder in train/prefill shapes.
    num_prefix_embeddings: int = 0
    # DeepSeek multi-token prediction depth (0 = off)
    mtp_depth: int = 0
    # logit softcap (gemma2-style, 0=off)
    logit_softcap: float = 0.0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads


def replace(cfg, **kw):
    """dataclasses.replace that works through our frozen configs."""
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# Q-GaLore / optimizer configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class QGaLoreConfig:
    """Everything controlling the paper's technique."""
    enabled: bool = True
    rank: int = 128                 # low-rank dimension r
    scale: float = 0.25             # GaLore alpha
    update_interval: int = 200      # initial SVD interval T
    # adaptive lazy update
    adaptive: bool = True
    cos_threshold: float = 0.4      # paper's 40% threshold
    adaptive_k: int = 3             # consecutive intervals above threshold
    max_interval: int = 3200        # cap on doubled interval
    # quantization
    proj_bits: int = 4              # INT4 projection
    weight_bits: int = 8            # INT8 weights (0 = keep bf16 weights)
    quant_block: int = 256          # paper's block size
    stochastic_rounding: bool = True
    # inner optimizer
    adam_bits: int = 8              # 8-bit Adam states (32 = fp32 states)
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    # dynamic rank adaptation (AdaRankGrad-style): shrink a leaf's rank
    # once the explained-variance ratio at the next-smaller rank stays at
    # or above the threshold for `rank_patience` consecutive refreshes
    adaptive_rank: bool = False
    # descending rank rungs, e.g. (128, 64, 32); empty = halve the current
    # rank per transition. `min_rank` floors the ladder either way.
    rank_ladder: Tuple[int, ...] = ()
    explained_ratio_threshold: float = 0.95
    rank_patience: int = 2
    min_rank: int = 8
    # ratios in [threshold - band, threshold) neither advance nor reset the
    # shrink streak; 0.0 = no dead band
    rank_hysteresis: float = 0.0
    # subspace method: "svd" (paper-faithful) | "randomized" (range finder)
    subspace_method: str = "svd"
    subspace_iters: int = 2         # power iterations for randomized method
    # which params get low-rank treatment
    min_dim: int = 128              # both dims must be >= this
    galore_embeddings: bool = False
    # execution: a steady update of an eligible leaf runs as ONE fused
    # kernel (kernels.ops.fused_qgalore_update); False runs the unfused
    # composition, the stage-by-stage chain's arithmetic
    fused_update: bool = True
    # data-parallel training (``train/step.py`` with a process group):
    # average the LOW-RANK gradient payload across ranks, not the
    # full-rank one
    compress_dp_grads: bool = False
    # at refresh steps, reduce-scatter a stacked leaf's full-rank gradient
    # over its layers, refresh each layer's P on the rank that owns it and
    # all-gather the results (leaves whose layer count the world size
    # divides; the rest refresh replicated)
    dist_refresh: bool = True


@dataclass(frozen=True)
class TrainConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 256
    steps: int = 100
    learning_rate: float = 1e-3
    warmup_steps: int = 10
    lr_schedule: str = "cosine"     # cosine | linear | constant
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0
    # checkpointing
    checkpoint_dir: str = ""
    checkpoint_every: int = 0       # 0 = off
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    log_every: int = 10


# ---------------------------------------------------------------------------
# Input shape cells
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)

# Archs for which long_500k runs (sub-quadratic decode); all others skip it.
LONG_CONTEXT_ARCHS = ("xlstm-125m", "zamba2-2.7b")


def cells_for_arch(arch_name: str):
    """The shape cells that apply to a given architecture."""
    return tuple(cell for cell in SHAPE_CELLS
                 if cell.name != "long_500k"
                 or arch_name in LONG_CONTEXT_ARCHS)
