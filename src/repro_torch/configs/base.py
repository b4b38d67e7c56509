"""Config system for the repro framework.

Every architecture is described by a single :class:`ModelConfig` dataclass.
Configs are registered by id (``--arch <id>``) in :data:`REGISTRY` and each
config module in this package registers itself on import.

Two kinds of configs exist:
  * FULL configs — the exact published architecture.  These are only ever
    *lowered* (dry-run, ShapeDtypeStruct) and never allocated on this host.
  * REDUCED configs — ``cfg.reduced()`` returns a tiny config of the same
    family used by CPU smoke tests (few layers, small width, tiny vocab).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""

    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0          # DeepSeek-style always-on shared experts
    d_ff_expert: int = 0               # per-expert hidden size
    dense_residual: bool = False       # Arctic-style parallel dense FFN
    d_ff_dense: int = 0                # hidden size of the parallel dense FFN
    router_dtype: str = "float32"
    capacity_factor: float = 1.25      # only used by dropping implementations
    first_dense_layers: int = 0        # DeepSeek: first N layers are dense FFN

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention configuration."""

    kv_lora_rank: int = 0              # compressed KV latent dim (c_kv)
    q_lora_rank: int = 0               # compressed Q latent dim (0 = full-rank Q)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def enabled(self) -> bool:
        return self.kv_lora_rank > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD configuration."""

    d_state: int = 0                   # N — SSM state size per head
    d_conv: int = 4                    # depthwise conv window
    expand: int = 2                    # d_inner = expand * d_model
    head_dim: int = 64                 # P — SSD head dim
    n_groups: int = 1                  # B/C groups (GVA-style)
    chunk_size: int = 256              # SSD chunk length for training/prefill

    @property
    def enabled(self) -> bool:
        return self.d_state > 0

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class AttnConfig:
    """Attention variant configuration."""

    sliding_window: int = 0            # 0 = full attention
    local_global_ratio: int = 0        # gemma3: N local layers per 1 global
    qk_norm: bool = False              # qwen3-style per-head RMSNorm on q,k
    rope_theta: float = 10000.0
    rope_local_theta: float = 0.0      # gemma3 uses a different theta for local
    logit_softcap: float = 0.0


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: SSM backbone + shared attention block."""

    shared_attn_every: int = 0         # apply the shared block every N ssm layers
    shared_attn_n_heads: int = 0
    concat_embedding: bool = True      # shared block sees concat([h, embed])

    @property
    def enabled(self) -> bool:
        return self.shared_attn_every > 0


# ---------------------------------------------------------------------------
# The main config
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "ssm", "hybrid", "moe", "vlm", "audio")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                    # 0 -> d_model // n_heads
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"                  # FFN activation (silu => SwiGLU, gelu => GeGLU)
    dtype: str = "bfloat16"
    attn: AttnConfig = field(default_factory=AttnConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    hybrid: HybridConfig = field(default_factory=HybridConfig)
    # modality frontends (vlm / audio) — the frontend itself is a stub; the
    # model consumes precomputed patch/frame embeddings via input_specs().
    frontend: str = "none"             # none | vision | audio
    n_frontend_tokens: int = 0         # vision patches prepended to the sequence
    n_codebooks: int = 0               # musicgen: parallel EnCodec codebooks
    # bookkeeping
    source: str = ""
    notes: str = ""

    # -- derived ------------------------------------------------------------
    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(self.n_heads, 1))
        assert self.family in FAMILIES, self.family

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid / windowed attn)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attn.sliding_window > 0  # SWA bounds the per-layer cache

    def layer_kinds(self) -> List[str]:
        """Per-layer block kind: 'attn' | 'attn_local' | 'attn_global' | 'ssm'."""
        kinds: List[str] = []
        for i in range(self.n_layers):
            if self.family in ("ssm", "hybrid"):
                # hybrid (zamba2): every indexed layer is an SSM block; the
                # shared attention block is counted separately (it is not a
                # per-layer module — its weights are stored once).
                kinds.append("ssm")
            elif self.attn.local_global_ratio > 0:
                r = self.attn.local_global_ratio
                kinds.append("attn_global" if (i + 1) % (r + 1) == 0 else "attn_local")
            elif self.attn.sliding_window > 0:
                kinds.append("attn_local")
            else:
                kinds.append("attn")
        return kinds

    def ffn_kind(self, layer_idx: int) -> str:
        if self.moe.enabled and layer_idx >= self.moe.first_dense_layers:
            return "moe"
        return "dense"

    # -- parameter count ----------------------------------------------------
    def param_count(self) -> int:
        """Exact parameter count of the FULL config (embedding included)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        total = V * d                       # token embedding
        if not self.tie_embeddings:
            total += V * d                  # lm head
        if self.n_codebooks > 1:            # musicgen: K embeddings + K heads
            total += (self.n_codebooks - 1) * V * d       # extra embeddings
            total += (self.n_codebooks - 1) * V * d       # extra heads
        total += d                          # final norm
        for i in range(L):
            total += self._layer_params(i)
        if self.hybrid.enabled:
            total += self._shared_attn_params()
        return total

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE counts only routed top-k)."""
        if not self.moe.enabled:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        total = self.param_count()
        moe_layers = L - self.moe.first_dense_layers
        inactive = self.moe.n_experts - self.moe.top_k
        per_expert = 3 * d * self.moe.d_ff_expert
        total -= moe_layers * inactive * per_expert
        return total

    def _attn_params(self, d: int) -> int:
        if self.mla.enabled:
            m = self.mla
            qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
            p = 0
            if m.q_lora_rank > 0:
                p += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_dim
                p += m.q_lora_rank  # q lora norm
            else:
                p += d * self.n_heads * qk_dim
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)      # kv down (+ shared rope key)
            p += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            p += m.kv_lora_rank                                  # kv lora norm
            p += self.n_heads * m.v_head_dim * d                 # o proj
            return p
        dh = self.d_head
        p = d * self.n_heads * dh                                # q
        p += 2 * d * self.n_kv_heads * dh                        # k, v
        p += self.n_heads * dh * d                               # o
        if self.attn.qk_norm:
            p += 2 * dh
        return p

    def _ffn_params(self, layer_idx: int, d: int) -> int:
        if self.ffn_kind(layer_idx) == "moe":
            m = self.moe
            p = d * m.n_experts                                  # router
            p += m.n_experts * 3 * d * m.d_ff_expert             # routed experts
            p += m.n_shared_experts * 3 * d * m.d_ff_expert      # shared experts
            if m.dense_residual:
                p += 3 * d * m.d_ff_dense                        # parallel dense FFN
            return p
        return 3 * d * self.d_ff                                 # gate/up/down

    def _ssm_params(self, d: int) -> int:
        s = self.ssm
        di = s.d_inner(d)
        nh = s.n_heads(d)
        conv_dim = di + 2 * s.n_groups * s.d_state
        p = d * (2 * di + 2 * s.n_groups * s.d_state + nh)       # in_proj (z,x,B,C,dt)
        p += conv_dim * s.d_conv + conv_dim                      # conv + bias
        p += nh * 2                                              # A_log, D
        p += nh                                                  # dt_bias
        p += di                                                  # gated norm
        p += di * d                                              # out_proj
        return p

    def _layer_params(self, i: int) -> int:
        d = self.d_model
        kind = self.layer_kinds()[i]
        p = 2 * d                                                # 2 pre-norms
        if kind == "ssm":
            p = d + self._ssm_params(d)                          # 1 norm for pure ssm block
            if self.family != "hybrid":
                p += d + self._ffn_params(i, d) if self.d_ff > 0 else 0
            return p
        p += self._attn_params(d)
        p += self._ffn_params(i, d)
        return p

    def _shared_attn_params(self) -> int:
        h = self.hybrid
        d = self.d_model * (2 if h.concat_embedding else 1)
        nh = h.shared_attn_n_heads
        dh = d // nh
        p = 2 * d                                                # norms
        p += 4 * d * nh * dh                                     # qkvo at concat width
        p += 3 * d * (self.d_ff or 4 * d) if False else 0
        p += self.d_model * d                                    # down-projection back
        return p

    # -- reduced config for smoke tests --------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        r = self.ssm
        red_ssm = (
            replace(r, d_state=16, head_dim=16, chunk_size=32)
            if r.enabled else r
        )
        red_moe = (
            replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=64 if self.moe.d_ff_expert else 0,
                d_ff_dense=64 if self.moe.dense_residual else 0,
                first_dense_layers=min(self.moe.first_dense_layers, 1),
            )
            if self.moe.enabled else self.moe
        )
        red_mla = (
            replace(self.mla, kv_lora_rank=32, q_lora_rank=(32 if self.mla.q_lora_rank else 0),
                    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
            if self.mla.enabled else self.mla
        )
        red_hybrid = (
            replace(self.hybrid, shared_attn_every=2, shared_attn_n_heads=4)
            if self.hybrid.enabled else self.hybrid
        )
        red_attn = replace(
            self.attn,
            sliding_window=min(self.attn.sliding_window, 16) if self.attn.sliding_window else 0,
        )
        n_layers = 4 if (self.attn.local_global_ratio or self.hybrid.enabled) else 2
        if self.attn.local_global_ratio:
            # keep the 5:1 pattern visible at reduced scale -> use 2:1 over 6 layers
            red_attn = replace(red_attn, local_global_ratio=2)
            n_layers = 6
        n_heads = 4
        d_model = 64
        return replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=max(1, min(self.n_kv_heads * n_heads // max(self.n_heads, 1), n_heads)),
            d_head=16,
            d_ff=128,
            vocab_size=256,
            ssm=red_ssm,
            moe=red_moe,
            mla=red_mla,
            hybrid=red_hybrid,
            attn=red_attn,
            n_frontend_tokens=8 if self.frontend != "none" else 0,
        )


# ---------------------------------------------------------------------------
# Input shapes (assigned per the task sheet; identical for all LM archs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> List[ShapeConfig]:
    """Shapes applicable to an architecture.

    ``long_500k`` requires sub-quadratic attention: it runs for SSM / hybrid /
    sliding-window archs and is skipped for pure full-attention archs
    (quadratic attention at 500k tokens does not fit the chip budget).
    """
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        out.append(SHAPES["long_500k"])
    return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    assert cfg.name not in REGISTRY, f"duplicate arch id {cfg.name}"
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # import side-effect: populate the registry
    from repro_torch import configs as _pkg  # noqa: F401

    _load_all()
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_archs() -> List[str]:
    _load_all()
    return sorted(REGISTRY)


_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # the port carries the paper's two evaluation models, mamba2 and
    # zamba2; the other architectures of the reference registry join with
    # their slices
    from repro_torch.configs import (  # noqa: F401
        llama2_7b,
        mamba2_2p7b,
        qwen3_8b,
        zamba2_2p7b,
    )
