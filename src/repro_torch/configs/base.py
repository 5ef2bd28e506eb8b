"""Config system of the LM stack: architecture, shape and parallelism configs.

The port's own copy of the JAX package's ``repro.configs.base`` (pure Python,
the same fields, defaults and derived counts), so that the port imports
nothing of that package. Every architecture has one module in
``repro_torch/configs/`` exporting a ``CONFIG`` (full size) and a
``SMOKE_CONFIG`` (a reduced config of the same family that runs on the CPU).
The one field the reference lacks is ``attention_impl``, the lowering of the
prefill attention: ``fused`` (K9, ``kernels/flash_attention.py``, on a CUDA
tensor; its plain version on a CPU tensor) or ``reference`` (the plain
chunked online softmax on any device), chosen as the brain's lowerings are.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ParallelConfig:
    """How a model is laid out on the mesh (see DESIGN.md §5)."""

    def replace(self, **kw) -> "ParallelConfig":
        return dataclasses.replace(self, **kw)

    # weight sharding
    fsdp_axis: str = "data"            # row-shard params over this axis when divisible
    tensor_axis: str = "model"         # col-shard params over this axis when divisible
    shard_params_fsdp: bool = True
    # 'tp'  : batch over DP axes, weights row x col sharded (Megatron-ish)
    # 'fsdp': batch over ALL axes, weights row-sharded over (data x model) —
    #         no TP activation all-reduces; per-layer bf16 weight gathers.
    #         MoE expert weights keep EP over 'model' in both layouts.
    layout: str = "tp"
    # MoE dispatch: 'move_data' | 'move_compute' | 'local' | 'auto' (cost model
    # picks whichever moves fewer bytes — the paper's principle generalized)
    moe_strategy: str = "auto"
    # decode attention: 'local' (batch-sharded KV) | 'split_kv' (seq-sharded +
    # psum combine — the move-compute pattern; also the only layout where a
    # 32k x 128 cache fits 16GB/chip for the big archs)
    decode_attention: str = "split_kv"
    # cross-entropy: 'dense' | 'vocab_parallel'
    ce_mode: str = "dense"
    # gradient sync period (paper's Delta; 1 = every step)
    grad_sync_period: int = 1
    grad_compression: str = "none"     # 'none' | 'int8'
    # remat policy for the scanned layer body: 'none'|'full'|'dots_saveable'
    remat: str = "full"
    # optimizer state dtype ('float32' | 'bfloat16'); bf16 lets 480B fit 16GB/chip
    opt_state_dtype: str = "float32"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- attention flavor ---
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0            # chatglm3: 0.5 (2d/partial rotary)
    qk_norm: bool = False              # qwen3
    qkv_bias: bool = False             # qwen2
    attn_window: int = 0               # >0 => local (sliding-window) attention
    attn_logit_softcap: float = 0.0
    # --- mlp flavor ---
    mlp_gated: bool = True             # SwiGLU (gated) vs plain GELU (starcoder2, whisper)
    # --- moe ---
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False   # arctic: parallel dense FFN + MoE
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # --- ssm / hybrid ---
    block_pattern: tuple = ()          # e.g. ('rglru','rglru','attn'); () => all 'attn'
    rglru_conv_width: int = 4
    sslstm_heads: int = 4              # xlstm sLSTM head count
    # --- encoder/decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0               # precomputed frame embeddings (frontend stub)
    # --- vlm (llava) ---
    num_patches: int = 0               # precomputed patch embeddings (frontend stub)
    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    scan_layers: bool = True           # stacked layer params (one leading L axis)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    # --- the port's lowering of the prefill attention ---
    attention_impl: str = "fused"      # 'fused' (K9) | 'reference' (plain)

    def __post_init__(self):
        if self.attention_impl not in ("fused", "reference"):
            raise ValueError(f"attention_impl must be 'fused' or "
                             f"'reference', got {self.attention_impl!r}")

    # ----- derived -----
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def pattern(self) -> tuple:
        """Per-layer block kinds, length num_layers."""
        if not self.block_pattern:
            return ("attn",) * self.num_layers
        reps = -(-self.num_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.num_layers]

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline + memory estimates)."""
        d, h = self.d_model, self.head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        for kind in self.pattern():
            if kind == "attn":
                attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.qkv_bias:
                    attn += self.q_dim + 2 * self.kv_dim
            elif kind == "rglru":
                # linear recurrent block: in/out proj + conv + gates (griffin-like)
                w = self.d_ff if self.d_ff else d
                attn = 2 * d * w + w * self.rglru_conv_width + 3 * w + w * d
            elif kind in ("mlstm", "slstm"):
                # xlstm block: up-proj(2x), qkv-ish gates, down-proj
                up = 2 * d
                attn = d * up * 2 + 4 * up * h + up * d
            else:
                raise ValueError(kind)
            if self.moe:
                nff = 3 if self.mlp_gated else 2
                ff = self.num_experts * nff * d * self.d_ff + d * self.num_experts
                if self.moe_dense_residual:
                    ff += nff * d * self.d_ff
            elif self.d_ff:
                nff = 3 if self.mlp_gated else 2
                ff = nff * d * self.d_ff
            else:
                ff = 0
            total += attn + ff + 2 * d  # + norms
        if self.encoder_layers:
            enc = self.encoder_layers * (
                2 * (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d)
                + (2 if not self.mlp_gated else 3) * d * self.d_ff + 4 * d)
            # decoder cross-attention adds one attn block per layer
            total += enc + self.num_layers * (d * self.q_dim + 2 * d * self.kv_dim
                                              + self.q_dim * d + d)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        nff = 3 if self.mlp_gated else 2
        per_layer_all = self.num_experts * nff * self.d_model * self.d_ff
        per_layer_act = self.top_k * nff * self.d_model * self.d_ff
        return full - self.num_layers * (per_layer_all - per_layer_act)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                           # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}

# archs whose every block attends over the full sequence (quadratic) skip long_500k
def supports_long_context(cfg: ModelConfig) -> bool:
    kinds = set(cfg.pattern())
    if kinds == {"attn"} and cfg.attn_window == 0:
        return False
    if "attn" in kinds and cfg.attn_window == 0 and cfg.family not in ("ssm", "hybrid"):
        return False
    return True


def applicable_shapes(cfg: ModelConfig):
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not supports_long_context(cfg):
            continue
        out.append(s)
    return out
