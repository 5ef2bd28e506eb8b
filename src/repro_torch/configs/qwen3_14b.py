"""qwen3-14b — dense GQA with per-head qk RMS-norm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=17_408, vocab_size=151_936,
    qk_norm=True, rope_theta=1_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-14b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    qk_norm=True, scan_layers=False,
)
