"""qwen2-72b [dense]: GQA with QKV bias (arXiv:2407.10671). The largest dense
arch in the pool — FSDP + TP + grad accumulation are required to fit."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    act="swiglu",
    grad_accum=16,
    int8_optimizer=True,
)
