"""llama-60m: GaLore/Q-GaLore pre-training config (paper Tables 1-2)."""
from repro_torch.config import ModelConfig, replace

CONFIG = ModelConfig(
    name="llama-60m", family="dense",
    num_layers=8, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=1376, vocab_size=32000,
)


def smoke_config():
    return replace(CONFIG, num_layers=2, d_model=64, num_heads=4,
                   num_kv_heads=4, d_ff=128, vocab_size=512)
