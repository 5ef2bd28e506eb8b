"""whisper-base — encoder-decoder transformer backbone; conv audio frontend is a
STUB: input_specs() provides precomputed frame embeddings (1500, d_model).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51_865,
    mlp_gated=False, norm_eps=1e-5, rotary_pct=0.0,  # learned/absolute positions
    encoder_layers=6, encoder_seq=1500,
    scan_layers=False,  # 6 layers — unrolled HLO is small
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-base-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    mlp_gated=False, rotary_pct=0.0,
    encoder_layers=2, encoder_seq=64, scan_layers=False,
)
