"""mistral-nemo-12b: dense GQA, 128k context [hf:mistralai/Mistral-Nemo-Base-2407]."""
from repro_torch.config import ModelConfig, replace

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=131072,
    rope_theta=1_000_000.0,
)


def smoke_config():
    return replace(CONFIG, num_layers=2, d_model=64, num_heads=4,
                   num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512)
