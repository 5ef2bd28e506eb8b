"""qwen2-7b — dense GQA decoder with QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4, head_dim=128,
    d_ff=18_944, vocab_size=152_064,
    qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-7b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    qkv_bias=True, scan_layers=False,
)
