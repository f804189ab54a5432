"""gemma-7b: GeGLU, head_dim=256, tied embeddings, 256k vocab [arXiv:2403.08295]."""
from repro_torch.config import ModelConfig, replace

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16,
    head_dim=256, d_ff=24576, vocab_size=256000,
    ffn_activation="gelu", tie_embeddings=True, embed_scale=True,
)


def smoke_config():
    return replace(CONFIG, num_layers=2, d_model=64, num_heads=4,
                   num_kv_heads=4, head_dim=32, d_ff=128, vocab_size=512)
