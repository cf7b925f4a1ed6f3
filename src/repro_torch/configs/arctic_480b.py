"""arctic-480b [moe]: 128 experts top-2 + dense residual FFN
(hf:Snowflake/snowflake-arctic-base). The dominant weight surface is the
expert bank — the strongest case for AxLLM reuse (Fig. 8: reuse grows with
matrix size/count) and the framework's expert-parallel + int8-optimizer path.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    capacity_factor=1.25,
    act="swiglu",
    grad_accum=32,
    int8_optimizer=True,
)
