"""Analytic FLOP and HBM-byte model of one step of an (arch, cell): the
counterpart of ``repro/analysis/analytic.py``, with its numbers.

Conventions (the reference's): 1 MAC = 2 FLOPs; causal attention uses
the S/2 average context; a training step is 4× the forward for the
per-layer stack (forward, recompute, 2× backward) and 3× for the
embedding and head; the optimizer adds the GaLore projection pair
(4·m·n·r a matrix) once a step. The encoder-decoder's per-token FLOPs
are normalized per decoder token, with 4× as many encoder tokens.
"""
from __future__ import annotations

from repro_torch.config import ModelConfig, ShapeCell


def _attn_flops_per_token(cfg: ModelConfig, ctx: int) -> float:
    """GQA/MLA attention layer, forward, per token with `ctx` average
    context length."""
    d = cfg.d_model
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.attention == "mla":
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        proj = (2 * d * m.q_lora_rank + 2 * m.q_lora_rank * H * qk
                + 2 * d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + 2 * m.kv_lora_rank * H * (m.qk_nope_head_dim
                                            + m.v_head_dim)
                + 2 * H * m.v_head_dim * d)
        attn = 2 * ctx * H * qk + 2 * ctx * H * m.v_head_dim
        return proj + attn
    proj = 2 * d * H * hd + 2 * 2 * d * KH * hd + 2 * H * hd * d
    attn = 2 * ctx * H * hd + 2 * ctx * H * hd
    return proj + attn


def _ffn_flops_per_token(d: int, f: int) -> float:
    return 6 * d * f                      # gate + up + down


def _moe_flops_per_token(cfg: ModelConfig) -> float:
    mc = cfg.moe
    d = cfg.d_model
    fl = 2 * d * mc.num_experts                     # router
    fl += mc.top_k * _ffn_flops_per_token(d, mc.expert_ff)
    if mc.num_shared_experts:
        fl += _ffn_flops_per_token(d, mc.expert_ff
                                   * mc.num_shared_experts)
    return fl


def _mamba_flops_per_token(cfg: ModelConfig) -> float:
    sc = cfg.ssm
    d = cfg.d_model
    di = sc.expand * d
    conv_ch = di + 2 * sc.state_dim
    H = di // sc.head_dim
    fl = 2 * d * (di + conv_ch + H)                 # in_proj
    fl += 2 * sc.conv_kernel * conv_ch              # depthwise conv
    # SSD: B x^T (state write) + C h (read) + intra-chunk quadratic
    fl += 2 * 2 * di * sc.state_dim
    fl += 2 * sc.chunk_size * di                    # intra-chunk L matmuls
    fl += 2 * di * d                                # out_proj
    return fl


def _mlstm_flops_per_token(cfg: ModelConfig) -> float:
    xc = cfg.xlstm
    d = cfg.d_model
    inner = int(xc.proj_factor * d)
    fl = 2 * d * 2 * inner                          # up
    fl += 3 * 2 * inner * inner                     # q, k, v
    fl += 2 * xc.chunk_size * inner * 2             # intra-chunk qk / pv
    fl += 2 * inner * inner / max(cfg.num_heads, 1)  # inter-chunk C read
    fl += 2 * inner * d                             # down
    return fl


def _slstm_flops_per_token(cfg: ModelConfig) -> float:
    d = cfg.d_model
    dh = d // cfg.num_heads
    fl = 2 * d * 4 * d                              # input gates
    fl += 4 * 2 * d * dh                            # block-diag recurrent
    fl += _ffn_flops_per_token(d, int(4 * d / 3))
    return fl


def forward_flops_per_token(cfg: ModelConfig, ctx: int) -> float:
    d, L = cfg.d_model, cfg.num_layers
    head = 2 * d * cfg.vocab_size
    if cfg.family in ("dense", "vlm"):
        per = _attn_flops_per_token(cfg, ctx) \
            + _ffn_flops_per_token(d, cfg.d_ff)
        return L * per + head
    if cfg.family == "moe":
        mc = cfg.moe
        n_dense = mc.first_dense_layers
        dense_ff = mc.dense_ff or cfg.d_ff
        per_attn = _attn_flops_per_token(cfg, ctx)
        fl = n_dense * (per_attn + _ffn_flops_per_token(d, dense_ff))
        fl += (L - n_dense) * (per_attn + _moe_flops_per_token(cfg))
        if cfg.mtp_depth:
            fl += per_attn + _ffn_flops_per_token(d, dense_ff) + head
        return fl + head
    if cfg.family == "xlstm":
        every = cfg.xlstm.slstm_every or L
        n_s = L // every
        n_m = L - n_s
        return n_m * _mlstm_flops_per_token(cfg) \
            + n_s * _slstm_flops_per_token(cfg) + head
    if cfg.family == "hybrid":
        hc = cfg.hybrid
        n_sites = L // hc.attn_every
        n_mamba = n_sites * (hc.attn_every - 1)
        site = (2 * 2 * d * d                       # fuse (2d->d)
                + _attn_flops_per_token(cfg, ctx)
                + _ffn_flops_per_token(d, cfg.d_ff)
                + 2 * d * d)                        # site_out
        return n_mamba * _mamba_flops_per_token(cfg) + n_sites * site + head
    if cfg.family == "encdec":
        n_enc = cfg.num_encoder_layers or L
        enc = n_enc * (_attn_flops_per_token(cfg, ctx)
                       + _ffn_flops_per_token(d, cfg.d_ff))
        dec = L * (2 * _attn_flops_per_token(cfg, ctx)
                   + _ffn_flops_per_token(d, cfg.d_ff))
        # enc tokens ≈ 4× dec tokens; normalize per dec token
        return 4 * enc + dec + head
    raise ValueError(cfg.family)


def galore_projection_flops(cfg: ModelConfig, rank: int = 128) -> float:
    """Per-step projection + back-projection over all 2-D stack weights,
    approximated as 4·r·Σ(m·n) ≈ 4·r·N_stack."""
    from repro_torch.models import model_zoo
    n = model_zoo.count_params(cfg)
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return 4.0 * rank * max(n - emb, 0)


def cell_flops(cfg: ModelConfig, cell: ShapeCell, rank: int = 128) -> float:
    """Total FLOPs of one step of this cell."""
    # enc-dec per-token flops are normalized per DECODER token (4× encoder
    # tokens folded in) — see forward_flops_per_token.
    tok_scale = (1.0 / 4.0) if cfg.family == "encdec" else 1.0
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len * tok_scale
        ctx = cell.seq_len // 2
        fwd = forward_flops_per_token(cfg, ctx)
        head = 2 * cfg.d_model * cfg.vocab_size
        return tokens * (4 * (fwd - head) + 3 * head) \
            + galore_projection_flops(cfg, rank)
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len * tok_scale
        return tokens * forward_flops_per_token(cfg, cell.seq_len // 2)
    # decode: one token per sequence, full context
    return cell.global_batch * forward_flops_per_token(cfg, cell.seq_len)


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """6·N_active·D (train) / 2·N_active·D (inference): the 'useful'
    FLOPs."""
    from repro_torch.models import model_zoo
    n = model_zoo.count_active_params(cfg)
    if cell.kind == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch


# ---------------------------------------------------------------------------
# Analytic HBM-bytes model
# ---------------------------------------------------------------------------

def _kv_cache_bytes(cfg: ModelConfig, batch: int, seq: int,
                    bytes_per: int = 2) -> float:
    L = cfg.num_layers
    if cfg.family == "xlstm":
        # recurrent state, O(1) in seq
        inner = int(cfg.xlstm.proj_factor * cfg.d_model)
        dh = inner // cfg.num_heads
        return L * batch * cfg.num_heads * dh * dh * 4
    if cfg.family == "hybrid":
        sc = cfg.ssm
        di = sc.expand * cfg.d_model
        H = di // sc.head_dim
        n_sites = L // cfg.hybrid.attn_every
        mamba = (L - n_sites) * batch * H * sc.head_dim * sc.state_dim * 4
        kv = n_sites * 2 * batch * seq * cfg.num_kv_heads \
            * cfg.resolved_head_dim * bytes_per
        return mamba + kv
    if cfg.attention == "mla":
        m = cfg.mla
        return L * batch * seq * (m.kv_lora_rank + m.qk_rope_head_dim) \
            * bytes_per
    return L * 2 * batch * seq * cfg.num_kv_heads \
        * cfg.resolved_head_dim * bytes_per


def cell_bytes(cfg: ModelConfig, cell: ShapeCell, *,
               weight_bytes_per_param: float = 1.0,
               rank: int = 128) -> float:
    """Total HBM bytes of one step. Counts the dominant streams:

    train   : 3× weights (fwd + recompute + bwd) + 4× low-rank opt states
              + 2× saved layer activations + grads payload
    prefill : 1× active weights + 3× activations + KV-cache write
    decode  : 1× active weights + 2× KV cache (read + update write)
    """
    from repro_torch.models import model_zoo
    n_total = model_zoo.count_params(cfg)
    n_active = model_zoo.count_active_params(cfg)
    d = cfg.d_model
    B, S = cell.global_batch, cell.seq_len

    if cell.kind == "train":
        w = 3.0 * n_total * weight_bytes_per_param
        opt = 4.0 * (n_total * rank / max(d, rank)) \
            * 1.0                                    # int8 low-rank moments
        acts = 2.0 * cfg.num_layers * B * S * d * 2.0
        grads = 2.0 * n_total * rank / max(d, rank) * 4.0
        return w + opt + acts + grads
    if cell.kind == "prefill":
        w = n_active * weight_bytes_per_param
        acts = 3.0 * cfg.num_layers * B * S * d * 2.0
        return w + acts + _kv_cache_bytes(cfg, B, S)
    # decode
    w = n_active * weight_bytes_per_param
    return w + 2.0 * _kv_cache_bytes(cfg, B, S)
