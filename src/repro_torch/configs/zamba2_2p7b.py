"""zamba2-2.7b — Mamba2 backbone + shared attention blocks (hybrid).

[arXiv:2411.15242; hf]  54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000
ssm_state=64.  54 Mamba2 layers with a single SHARED transformer block applied
every 6 SSM layers; the shared block sees concat([h, embed]) (2*d_model) and
projects back to d_model.
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,              # shared block FFN width
    vocab_size=32000,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    hybrid=HybridConfig(shared_attn_every=6, shared_attn_n_heads=32,
                        concat_embedding=True),
    source="arXiv:2411.15242",
    notes="hybrid; runs long_500k (SSM state constant, shared-attn cache small)",
))
