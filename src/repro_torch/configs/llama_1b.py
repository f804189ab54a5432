"""llama-1b: GaLore/Q-GaLore pre-training config (paper Tables 1-2)."""
from repro_torch.config import ModelConfig, replace

CONFIG = ModelConfig(
    name="llama-1b", family="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=5461, vocab_size=32000,
)


def smoke_config():
    return replace(CONFIG, num_layers=2, d_model=64, num_heads=4,
                   num_kv_heads=4, d_ff=128, vocab_size=512)
