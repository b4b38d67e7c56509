"""mamba2-2.7b — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  64L d_model=2560 d_ff=0 vocab=50280 ssm_state=128.
Pure Mamba-2: each block is in_proj -> conv -> SSD -> gated norm -> out_proj,
no separate FFN (d_ff=0).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=80,              # d_inner(5120) / head_dim(64)
    n_kv_heads=80,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    source="arXiv:2405.21060",
    notes="SSD (state-space duality); attention-free; runs long_500k",
))
