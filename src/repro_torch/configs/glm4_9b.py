"""glm4-9b [dense]: RoPE + GQA with only 2 KV heads (hf:THUDM/glm-4-9b).
kv=2 cannot shard 16-way -> the divisibility fallback replicates KV
projections and the KV cache shards its *sequence* dim instead."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    head_dim=128,
    act="swiglu",
    grad_accum=4,
)
