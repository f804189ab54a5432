"""qwen3-moe-30b-a3b: 128 experts top-8, qk-norm, GQA [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.config import ModelConfig, MoEConfig, replace

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    head_dim=128, d_ff=768, vocab_size=151936, qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, expert_ff=768),
)


def smoke_config():
    return replace(CONFIG, num_layers=2, d_model=64, num_heads=4,
                   num_kv_heads=2, head_dim=16, vocab_size=512, d_ff=32,
                   moe=MoEConfig(num_experts=8, top_k=2, expert_ff=32))
