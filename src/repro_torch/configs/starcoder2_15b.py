"""starcoder2-15b — dense GQA + RoPE, plain-GELU MLP. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4, head_dim=128,
    d_ff=24_576, vocab_size=49_152,
    mlp_gated=False, qkv_bias=True, rope_theta=100_000.0, norm_eps=1e-5,
)

SMOKE_CONFIG = ModelConfig(
    name="starcoder2-15b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    mlp_gated=False, qkv_bias=True, scan_layers=False,
)
