"""xlstm-125m — alternating sLSTM + mLSTM blocks; attention-free (runs long_500k).
d_ff=0: xLSTM blocks carry their own up/down projections. [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4, head_dim=192,
    d_ff=0, vocab_size=50_304,
    block_pattern=("mlstm", "slstm"),
    scan_layers=False,  # heterogeneous 12-layer stack — unroll
)

SMOKE_CONFIG = ModelConfig(
    name="xlstm-125m-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
    d_ff=0, vocab_size=512,
    block_pattern=("mlstm", "slstm"), scan_layers=False,
)
