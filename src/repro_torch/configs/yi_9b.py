"""yi-9b: llama-arch dense GQA [arXiv:2403.04652]."""
from repro_torch.config import ModelConfig, replace

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
    head_dim=128, d_ff=11008, vocab_size=64000,
    rope_theta=5_000_000.0,
)


def smoke_config():
    return replace(CONFIG, num_layers=2, d_model=64, num_heads=4,
                   num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512)
