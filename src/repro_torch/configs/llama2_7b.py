"""llama2-7b — the paper's primary evaluation model (HALO Section V).

32L d_model=4096 32H (MHA) d_ff=11008 vocab=32000.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    attn=AttnConfig(rope_theta=10000.0),
    source="arXiv:2307.09288",
    notes="paper eval model (HALO Fig. 4-10)",
))
