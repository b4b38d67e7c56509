"""qwen3-8b — the paper's second evaluation model (HALO Section V).

36L d_model=4096 32H (GQA kv=8, d_head=128) d_ff=12288 vocab=151936.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=12288,
    vocab_size=151936,
    attn=AttnConfig(qk_norm=True, rope_theta=1_000_000.0),
    source="arXiv:2505.09388",
    notes="paper eval model (HALO Fig. 7-8)",
))
