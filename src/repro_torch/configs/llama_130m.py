"""llama-130m: GaLore/Q-GaLore pre-training config (paper Tables 1-2)."""
from repro_torch.config import ModelConfig, replace

CONFIG = ModelConfig(
    name="llama-130m", family="dense",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=2048, vocab_size=32000,
)


def smoke_config():
    return replace(CONFIG, num_layers=2, d_model=64, num_heads=4,
                   num_kv_heads=4, d_ff=128, vocab_size=512)
