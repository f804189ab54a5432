"""llama-350m: GaLore/Q-GaLore pre-training config (paper Tables 1-2)."""
from repro_torch.config import ModelConfig, replace

CONFIG = ModelConfig(
    name="llama-350m", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=2736, vocab_size=32000,
)


def smoke_config():
    return replace(CONFIG, num_layers=2, d_model=64, num_heads=4,
                   num_kv_heads=4, d_ff=128, vocab_size=512)
