"""llava-next-34b — VLM text backbone (Yi-34B-class); anyres tiling frontend is a
STUB: input_specs() provides precomputed patch embeddings (num_patches, d_model).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=20_480, vocab_size=64_000,
    rope_theta=5_000_000.0,
    num_patches=2880,  # anyres: base 576 + 4 tiles x 576
)

SMOKE_CONFIG = ModelConfig(
    name="llava-next-34b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    num_patches=16, scan_layers=False,
)
