"""chameleon-34b [vlm]: early-fusion VLM backbone (arXiv:2405.09818).

The modality frontend (VQ image tokenizer) is a STUB: image tokens share the
65536-entry vocabulary, so `input_specs()` feeds token ids only. Backbone is
a dense llama-like decoder with qk-norm (chameleon's stabilization trick).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    head_dim=128,
    qk_norm=True,
    act="swiglu",
    grad_accum=16,
    int8_optimizer=True,
)
