"""deepseek-v3-671b: MLA, 1 shared + 256 routed top-8 experts, MTP [arXiv:2412.19437]."""
from repro_torch.config import MLAConfig, ModelConfig, MoEConfig, replace

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=2048, vocab_size=129280,
    attention="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, num_shared_experts=1,
                  expert_ff=2048, first_dense_layers=3, dense_ff=18432),
    mtp_depth=1,
)


def smoke_config():
    return replace(CONFIG, num_layers=3, d_model=64, num_heads=4,
                   num_kv_heads=4, vocab_size=512, d_ff=32,
                   mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                 qk_nope_head_dim=16, qk_rope_head_dim=8,
                                 v_head_dim=16),
                   moe=MoEConfig(num_experts=8, top_k=2,
                                 num_shared_experts=1, expert_ff=32,
                                 first_dense_layers=1, dense_ff=128))
