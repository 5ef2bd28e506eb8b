"""chatglm3-6b — dense GQA(kv=2), 2d/partial RoPE (rotary on half dims).
[arXiv:2406.12793; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2, head_dim=128,
    d_ff=13_696, vocab_size=65_024,
    rotary_pct=0.5, qkv_bias=True, norm_eps=1e-5,
)

SMOKE_CONFIG = ModelConfig(
    name="chatglm3-6b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    rotary_pct=0.5, qkv_bias=True, scan_layers=False,
)
