"""zamba2-2.7b: Mamba2 backbone + shared attention every 6 layers with per-site LoRA [arXiv:2411.15242]."""
from repro_torch.config import HybridConfig, ModelConfig, SSMConfig, replace

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_kernel=4,
                  chunk_size=256),
    hybrid=HybridConfig(attn_every=6, shared_lora_rank=64),
)


def smoke_config():
    return replace(CONFIG, num_layers=6, d_model=64, num_heads=4,
                   num_kv_heads=4, d_ff=128, vocab_size=512,
                   ssm=SSMConfig(state_dim=16, head_dim=16, expand=2,
                                 conv_kernel=4, chunk_size=16),
                   hybrid=HybridConfig(attn_every=3, shared_lora_rank=8))
