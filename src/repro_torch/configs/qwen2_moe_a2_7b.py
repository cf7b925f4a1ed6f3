"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed experts top-4
(hf:Qwen/Qwen1.5-MoE-A2.7B). 60 experts pad to 64 for even 16-way expert
sharding (dummy experts masked -inf in the router — exact)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    head_dim=128,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    expert_pad_to=16,          # 60 -> 64
    capacity_factor=1.25,
    qkv_bias=True,
    act="swiglu",
    grad_accum=4,
)
