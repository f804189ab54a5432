"""seamless-m4t-medium: enc-dec multimodal backbone; audio frontend stubbed [arXiv:2308.11596]."""
from repro_torch.config import ModelConfig, replace

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, num_encoder_layers=12,
    d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206,
)


def smoke_config():
    return replace(CONFIG, num_layers=2, num_encoder_layers=2, d_model=64,
                   num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512)
