"""qwen3-32b: dense GQA with qk-norm [hf:Qwen/Qwen3-32B]."""
from repro_torch.config import ModelConfig, replace

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=25600, vocab_size=151936, qk_norm=True,
    rope_theta=1_000_000.0,
)


def smoke_config():
    return replace(CONFIG, num_layers=2, d_model=64, num_heads=4,
                   num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512)
