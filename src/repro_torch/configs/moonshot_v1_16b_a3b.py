"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=163_840,
    moe=True, num_experts=64, top_k=6,
    rope_theta=50_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=48, vocab_size=512,
    moe=True, num_experts=8, top_k=2,
    scan_layers=False,
)
