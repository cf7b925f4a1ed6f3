"""whisper-small [audio]: the encoder-decoder backbone (arXiv:2212.04356);
the conv/mel frontend is a stub, as in the JAX package: callers supply
precomputed frame features [B, 1500, 80]. GELU and LayerNorm as in the
original; embeddings tied."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    is_encoder_decoder=True,
    n_enc_layers=12,
    enc_seq=1500,
    d_feat=80,
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    grad_accum=2,
)
