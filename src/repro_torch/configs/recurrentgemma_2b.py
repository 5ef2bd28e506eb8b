"""recurrentgemma-2b — Griffin: RG-LRU recurrent blocks + local attention, 2:1
pattern (rec, rec, attn). Sub-quadratic => runs long_500k. [arXiv:2402.19427; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256_000,
    block_pattern=("rglru", "rglru", "attn"),
    attn_window=2048, attn_logit_softcap=0.0,
    scan_layers=False,  # heterogeneous pattern — unroll (26 small layers)
)

SMOKE_CONFIG = ModelConfig(
    name="recurrentgemma-2b-smoke", family="hybrid",
    num_layers=3, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
    d_ff=128, vocab_size=512,
    block_pattern=("rglru", "rglru", "attn"), attn_window=16,
    scan_layers=False,
)
