"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks (arXiv:2405.04517), ratio 7:1
(every 8th block is sLSTM -> 6 superblocks of 7 mLSTM + 1 sLSTM = 48).
d_ff=0: blocks carry their own projections (mLSTM pre-up x2, sLSTM GeGLU 4/3).
Constant-size recurrent state => runs the long_500k cell."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm_slstm_every=8,
    ssm_conv=4,
    act="gelu",
    grad_accum=8,
)
