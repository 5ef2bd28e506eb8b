"""arctic-480b — Snowflake Arctic: 128-expert top-2 MoE + dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32_000,
    moe=True, num_experts=128, top_k=2, moe_dense_residual=True,
    rope_theta=10_000.0,
    # 480B params: bf16 optimizer state so param+m+v+grad fits 16GB/chip at 256-way
    parallel=ParallelConfig(opt_state_dtype="bfloat16"),
)

SMOKE_CONFIG = ModelConfig(
    name="arctic-480b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=48, vocab_size=512,
    moe=True, num_experts=8, top_k=2, moe_dense_residual=True,
    scan_layers=False,
)
