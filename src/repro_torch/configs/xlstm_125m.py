"""xlstm-125m: sLSTM + mLSTM blocks [arXiv:2405.04517]. d_ff=0 (projections live in-block)."""
from repro_torch.config import ModelConfig, XLSTMConfig, replace

CONFIG = ModelConfig(
    name="xlstm-125m", family="xlstm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=6, proj_factor=2.0, chunk_size=256),
)


def smoke_config():
    return replace(CONFIG, num_layers=4, d_model=64, num_heads=2,
                   num_kv_heads=2, vocab_size=512,
                   xlstm=XLSTMConfig(slstm_every=2, proj_factor=2.0,
                                     chunk_size=16))
