"""internvl2-2b: InternViT frontend (stubbed) + InternLM2-1.8B backbone [arXiv:2404.16821]."""
from repro_torch.config import ModelConfig, replace

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553, rope_theta=1_000_000.0,
    num_prefix_embeddings=256,
)


def smoke_config():
    return replace(CONFIG, num_layers=2, d_model=64, num_heads=4,
                   num_kv_heads=2, d_ff=128, vocab_size=512,
                   num_prefix_embeddings=8)
