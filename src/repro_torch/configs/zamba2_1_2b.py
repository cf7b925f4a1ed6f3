"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block every 6
layers (arXiv:2411.15242). ssm_state=64; 38 = 6 groups x 6 + 2 remainder
mamba layers. Sub-quadratic state => runs the long_500k cell."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    hybrid_attn_every=6,
    act="gelu",
    grad_accum=8,
)
