"""ModelConfig: the dataclass describing a model, and its reduced variant.

A field-for-field copy of the JAX package's ``configs/base.py`` so that a
config built here and one built there describe the same model, with the
same derived sizes (padded vocab and experts, parameter counts).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_dense_residual: bool = False
    capacity_factor: float = 1.25
    expert_pad_to: int = 16

    # --- attention ----------------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4

    # --- block --------------------------------------------------------------
    act: str = "swiglu"                   # swiglu | gelu
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- SSM / xLSTM / hybrid ------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    xlstm_slstm_every: int = 0
    hybrid_attn_every: int = 0

    # --- encoder-decoder ------------------------------------------------------
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500
    d_feat: int = 80

    # --- padding -------------------------------------------------------------
    vocab_pad_multiple: int = 256

    # --- training / memory knobs ---------------------------------------------
    remat: bool = True
    grad_accum: int = 1
    grad_accum_dtype: str = "float32"
    scan_layers: bool = True
    int8_optimizer: bool = False
    dtype: str = "bfloat16"

    # --- AxLLM serving -------------------------------------------------------
    quant_bits: int = 8                   # serve-path weight codes
    quant_kv: bool = False                # int8 KV cache
    fuse_qkv: bool = False                # fused wqkv/gate_up projections
    decode_chunk: int = 8                 # decode steps per dispatch
    shard_cache_seq: bool = True
    eos_id: Optional[int] = None          # serve-path stop token

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def padded_experts(self) -> int:
        if not self.n_experts:
            return 0
        m = self.expert_pad_to
        return ((self.n_experts + m - 1) // m) * m

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic state: SSM/hybrid run long_500k; attention archs
        skip."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # every pool arch decodes (whisper via its decoder)

    def n_params(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, dff, hd = self.d_model, self.d_ff, self.resolved_head_dim
        h, hk = self.n_heads, self.n_kv_heads
        attn = d * h * hd + 2 * d * hk * hd + h * hd * d
        if self.act == "swiglu":
            ffn = 3 * d * dff
        else:
            ffn = 2 * d * dff
        per_layer = attn
        if self.family == "moe":
            shared = 3 * d * dff * self.n_shared_experts
            routed = 3 * d * dff * self.n_experts
            dense_res = 3 * d * dff if self.moe_dense_residual else 0
            per_layer += shared + routed + dense_res + d * self.n_experts
        elif self.family in ("ssm",):      # xLSTM: internal projections
            di = self.ssm_expand * d
            per_layer += 2 * d * di + di * d + 4 * (di // 1) * hd
        elif self.family == "hybrid":
            di = self.ssm_expand * d
            per_layer += 2 * d * di + di * d
        else:
            per_layer += ffn
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        enc = 0
        if self.is_encoder_decoder:
            enc = self.n_enc_layers * (attn + ffn)
        return self.n_layers * per_layer + emb + enc

    def n_active_params(self) -> int:
        """Per-token active params (MoE: top_k + shared + dense residual)."""
        if self.family != "moe":
            return self.n_params()
        d, dff = self.d_model, self.d_ff
        full = self.n_params()
        routed_all = self.n_layers * 3 * d * dff * self.n_experts
        routed_active = self.n_layers * 3 * d * dff * self.top_k
        return full - routed_all + routed_active

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU tests (same rule as the JAX
        package, so both packages reduce a config to the same shapes)."""
        small = dict(
            n_layers=min(self.n_layers, 2 if not self.xlstm_slstm_every
                         else self.xlstm_slstm_every),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads <
            self.n_heads else 4,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32,
            vocab_pad_multiple=64,
            grad_accum=1,
        )
        if self.n_experts:
            small.update(n_experts=8, top_k=min(self.top_k, 2),
                         n_shared_experts=min(self.n_shared_experts, 1),
                         expert_pad_to=8, capacity_factor=8.0)
        if self.ssm_state:
            small.update(ssm_state=16, ssm_head_dim=16)
        if self.is_encoder_decoder:
            small.update(n_enc_layers=2, enc_seq=64, d_feat=16)
        if self.hybrid_attn_every:
            small.update(n_layers=4, hybrid_attn_every=2)
        if self.xlstm_slstm_every:
            small.update(n_layers=4, xlstm_slstm_every=2)
        small.update(overrides)
        return dataclasses.replace(self, **small)
