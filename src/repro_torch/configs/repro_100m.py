"""repro-100m: the ~100M-parameter dense LM the port serves end to end."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="repro-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=2048,
    vocab_size=32000,
    head_dim=64,
    act="swiglu",
    grad_accum=1,
    tie_embeddings=True,
)
