"""Operator-graph extraction: ModelConfig x (phase, context, batch) -> ops.

This is the workload half of the HALO analytical model (Section IV-B /
Fig. 4 of the paper profile exactly these operators).  Every transformer /
SSD / MoE / MLA sub-operation becomes an :class:`Op` with its matmul
dimensions, the bytes it must stream from memory (weights, or KV cache —
whatever is resident in DRAM), and elementwise/special-function op counts
for the non-GEMM units.

The paper evaluates dense models (LLaMA-2 7B, Qwen3 8B); the extraction
below also covers the assigned MoE / MLA / SSM / hybrid architectures so the
phase-aware mapping can be studied beyond the paper (EXPERIMENTS.md §Beyond).

Conventions:
  * weights and KV are 8-bit (HALO computes int8 end-to-end): 1 byte/elem.
  * ``m`` is the GEMM M dimension (tokens in flight).  Decode ops therefore
    have m == batch — the engines decide memory- vs compute-bound from that.
  * ``count`` replicates an op (e.g. once per layer).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from repro_torch.configs.base import ModelConfig

BYTES = 1  # int8


@dataclass(frozen=True)
class Op:
    name: str
    kind: str                 # "matmul" | "attn" | "ew" | "softmax" | "norm"
    m: int = 0                # matmul dims (per instance)
    k: int = 0
    n: int = 0
    batch: int = 1            # independent matmul instances (e.g. B*H)
    stream_bytes: int = 0     # bytes streamed from DRAM (weights / KV cache)
    ew_ops: int = 0           # elementwise ops (vector unit)
    sfu_ops: int = 0          # exp/rsqrt ops (SFU)
    count: int = 1            # replication across layers
    is_attention: bool = False

    @property
    def flops(self) -> int:
        mm = 2 * self.m * self.k * self.n * self.batch
        return (mm + self.ew_ops + self.sfu_ops) * self.count

    @property
    def total_stream(self) -> int:
        return self.stream_bytes * self.count


def _norm_op(name, tokens, d, count=1) -> Op:
    return Op(name, "norm", ew_ops=4 * tokens * d, sfu_ops=tokens,
              stream_bytes=tokens * d * BYTES, count=count)


def _softmax_op(name, rows, width, count=1) -> Op:
    return Op(name, "softmax", ew_ops=3 * rows * width, sfu_ops=rows * width,
              stream_bytes=0, count=count)


def _attn_ctx(cfg: ModelConfig, layer_window: int, ctx: int) -> int:
    """Effective attended context for a layer (sliding window bounds it)."""
    return min(ctx, layer_window) if layer_window > 0 else ctx


def _layer_windows(cfg: ModelConfig) -> List[int]:
    out = []
    for kind in cfg.layer_kinds():
        if kind == "attn_local":
            out.append(cfg.attn.sliding_window)
        elif kind.startswith("attn"):
            out.append(0)
    return out


# ---------------------------------------------------------------------------
# per-phase extraction
# ---------------------------------------------------------------------------

def prefill_ops(cfg: ModelConfig, l_in: int, batch: int) -> List[Op]:
    """Operator list for one full prefill pass."""
    d = cfg.d_model
    T = batch * l_in
    ops: List[Op] = []
    ops.append(Op("embed", "ew", ew_ops=T * d, stream_bytes=T * d * BYTES))

    for i in range(cfg.n_layers):
        kind = cfg.layer_kinds()[i]
        suffix = f"@L{i}"
        if kind == "ssm":
            ops += _ssm_ops(cfg, l_in, batch, phase="prefill", idx=i)
        else:
            window = (cfg.attn.sliding_window
                      if kind == "attn_local" else 0)
            ops += _attn_block_ops(cfg, l_in, batch, window, phase="prefill",
                                   ctx=l_in, idx=i)
        ops += _ffn_ops(cfg, i, T, batch, phase="prefill")
    if cfg.hybrid.enabled:
        ops += _shared_attn_ops(cfg, l_in, batch, phase="prefill", ctx=l_in)

    ops.append(_norm_op("final_norm", T, d))
    # only the last position feeds the LM head during prefill
    V = cfg.vocab_size
    ops.append(Op("lm_head", "matmul", m=batch, k=d, n=V,
                  stream_bytes=d * V * BYTES))
    return ops


def decode_ops(cfg: ModelConfig, ctx: int, batch: int) -> List[Op]:
    """Operator list for generating ONE token at context length ``ctx``."""
    d = cfg.d_model
    ops: List[Op] = []
    ops.append(Op("embed", "ew", ew_ops=batch * d,
                  stream_bytes=batch * d * BYTES))
    for i in range(cfg.n_layers):
        kind = cfg.layer_kinds()[i]
        if kind == "ssm":
            ops += _ssm_ops(cfg, 1, batch, phase="decode", idx=i)
        else:
            window = (cfg.attn.sliding_window
                      if kind == "attn_local" else 0)
            ops += _attn_block_ops(cfg, 1, batch, window, phase="decode",
                                   ctx=ctx, idx=i)
        ops += _ffn_ops(cfg, i, batch, batch, phase="decode")
    if cfg.hybrid.enabled:
        ops += _shared_attn_ops(cfg, 1, batch, phase="decode", ctx=ctx)
    ops.append(_norm_op("final_norm", batch, d))
    V = cfg.vocab_size
    ops.append(Op("lm_head", "matmul", m=batch, k=d, n=V,
                  stream_bytes=d * V * BYTES))
    return ops


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_block_ops(cfg, l_q: int, batch: int, window: int, phase: str,
                    ctx: int, idx: int) -> List[Op]:
    d = cfg.d_model
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    T = batch * l_q
    eff_ctx = _attn_ctx(cfg, window, ctx)
    ops: List[Op] = [_norm_op(f"ln1@L{idx}", T, d)]

    if cfg.mla.enabled:
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        rank = m.kv_lora_rank
        q_in = m.q_lora_rank if m.q_lora_rank else d
        if m.q_lora_rank:
            ops.append(Op(f"q_down@L{idx}", "matmul", m=T, k=d, n=m.q_lora_rank,
                          stream_bytes=d * m.q_lora_rank))
        ops.append(Op(f"q_up@L{idx}", "matmul", m=T, k=q_in, n=H * qk,
                      stream_bytes=q_in * H * qk))
        ops.append(Op(f"kv_down@L{idx}", "matmul", m=T, k=d,
                      n=rank + m.qk_rope_head_dim,
                      stream_bytes=d * (rank + m.qk_rope_head_dim)))
        if phase == "prefill":
            # materialize K/V from latent: GEMM over T tokens
            ops.append(Op(f"kv_up@L{idx}", "matmul", m=T, k=rank,
                          n=H * (m.qk_nope_head_dim + m.v_head_dim),
                          stream_bytes=rank * H * (m.qk_nope_head_dim + m.v_head_dim)))
            score_ctx, v_dim = eff_ctx, m.v_head_dim
            ops.append(Op(f"scores@L{idx}", "attn", m=l_q, k=qk, n=score_ctx,
                          batch=batch * H, stream_bytes=0, is_attention=True))
            ops.append(_softmax_op(f"softmax@L{idx}", batch * H * l_q, score_ctx))
            ops.append(Op(f"attn_v@L{idx}", "attn", m=l_q, k=score_ctx, n=v_dim,
                          batch=batch * H, stream_bytes=0, is_attention=True))
        else:
            # absorbed decode: GEMV over the latent cache
            cache_bytes = batch * eff_ctx * (rank + m.qk_rope_head_dim) * BYTES
            ops.append(Op(f"q_absorb@L{idx}", "matmul", m=batch, k=m.qk_nope_head_dim,
                          n=rank, batch=H, stream_bytes=H * m.qk_nope_head_dim * rank))
            ops.append(Op(f"scores@L{idx}", "attn", m=1, k=rank + m.qk_rope_head_dim,
                          n=eff_ctx, batch=batch * H, stream_bytes=cache_bytes,
                          is_attention=True))
            ops.append(_softmax_op(f"softmax@L{idx}", batch * H, eff_ctx))
            ops.append(Op(f"attn_v@L{idx}", "attn", m=1, k=eff_ctx, n=rank,
                          batch=batch * H, stream_bytes=cache_bytes,
                          is_attention=True))
            ops.append(Op(f"v_absorb@L{idx}", "matmul", m=batch, k=rank,
                          n=m.v_head_dim, batch=H,
                          stream_bytes=H * rank * m.v_head_dim))
        ops.append(Op(f"o_proj@L{idx}", "matmul", m=T, k=H * m.v_head_dim, n=d,
                      stream_bytes=H * m.v_head_dim * d))
        return ops

    # standard GQA
    ops.append(Op(f"qkv@L{idx}", "matmul", m=T, k=d, n=(H + 2 * Hkv) * dh,
                  stream_bytes=d * (H + 2 * Hkv) * dh))
    ops.append(Op(f"rope@L{idx}", "ew", ew_ops=4 * T * (H + Hkv) * dh))
    kv_bytes = batch * eff_ctx * Hkv * dh * BYTES
    if phase == "prefill":
        # causal: average attended length ~ eff_ctx/2 for full attention
        avg_ctx = (eff_ctx + 1) // 2 if window == 0 else eff_ctx
        ops.append(Op(f"scores@L{idx}", "attn", m=l_q, k=dh, n=avg_ctx,
                      batch=batch * H, stream_bytes=0, is_attention=True))
        ops.append(_softmax_op(f"softmax@L{idx}", batch * H * l_q, avg_ctx))
        ops.append(Op(f"attn_v@L{idx}", "attn", m=l_q, k=avg_ctx, n=dh,
                      batch=batch * H, stream_bytes=0, is_attention=True))
    else:
        ops.append(Op(f"scores@L{idx}", "attn", m=1, k=dh, n=eff_ctx,
                      batch=batch * H, stream_bytes=kv_bytes, is_attention=True))
        ops.append(_softmax_op(f"softmax@L{idx}", batch * H, eff_ctx))
        ops.append(Op(f"attn_v@L{idx}", "attn", m=1, k=eff_ctx, n=dh,
                      batch=batch * H, stream_bytes=kv_bytes, is_attention=True))
    ops.append(Op(f"o_proj@L{idx}", "matmul", m=T, k=H * dh, n=d,
                  stream_bytes=H * dh * d))
    return ops


def _ffn_ops(cfg, idx: int, T: int, batch: int, phase: str) -> List[Op]:
    d = cfg.d_model
    ops: List[Op] = []
    if cfg.layer_kinds()[idx] == "ssm" and (cfg.d_ff == 0
                                            or cfg.family == "hybrid"):
        return ops                      # hybrid: FFN lives in the shared block
    if cfg.ffn_kind(idx) == "moe":
        m = cfg.moe
        ops.append(_norm_op(f"ln2@L{idx}", T, d))
        ops.append(Op(f"router@L{idx}", "matmul", m=T, k=d, n=m.n_experts,
                      stream_bytes=d * m.n_experts))
        # routed experts: tokens*top_k rows; streamed weights depend on phase
        if phase == "decode" and batch * m.top_k < m.n_experts:
            active = batch * m.top_k            # distinct experts touched (<=)
        else:
            active = m.n_experts
        w_bytes = active * 3 * d * m.d_ff_expert * BYTES
        ops.append(Op(f"moe_ffn@L{idx}", "matmul", m=T * m.top_k, k=d,
                      n=m.d_ff_expert, batch=3, stream_bytes=w_bytes))
        ops.append(Op(f"moe_act@L{idx}", "ew", ew_ops=4 * T * m.top_k * m.d_ff_expert))
        if m.n_shared_experts:
            ff = m.n_shared_experts * m.d_ff_expert
            ops.append(Op(f"shared_ffn@L{idx}", "matmul", m=T, k=d, n=ff,
                          batch=3, stream_bytes=3 * d * ff))
        if m.dense_residual:
            ops.append(Op(f"dense_res@L{idx}", "matmul", m=T, k=d, n=m.d_ff_dense,
                          batch=3, stream_bytes=3 * d * m.d_ff_dense))
    else:
        ff = cfg.d_ff
        ops.append(_norm_op(f"ln2@L{idx}", T, d))
        ops.append(Op(f"ffn@L{idx}", "matmul", m=T, k=d, n=ff, batch=3,
                      stream_bytes=3 * d * ff))
        ops.append(Op(f"ffn_act@L{idx}", "ew", ew_ops=4 * T * ff))
    return ops


def _ssm_ops(cfg, l_q: int, batch: int, phase: str, idx: int) -> List[Op]:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    gn = s.n_groups * s.d_state
    T = batch * l_q
    in_dim = 2 * di + 2 * gn + nh
    ops: List[Op] = [_norm_op(f"ln1@L{idx}", T, d)]
    ops.append(Op(f"ssm_in@L{idx}", "matmul", m=T, k=d, n=in_dim,
                  stream_bytes=d * in_dim))
    ops.append(Op(f"conv@L{idx}", "ew", ew_ops=2 * T * (di + 2 * gn) * s.d_conv))
    if phase == "prefill":
        # chunked SSD: intra-chunk GEMMs dominate
        Q = min(s.chunk_size, l_q)
        nc = max(l_q // Q, 1)
        ops.append(Op(f"ssd_cb@L{idx}", "attn", m=Q, k=s.d_state, n=Q,
                      batch=batch * nc * s.n_groups, is_attention=True))
        ops.append(Op(f"ssd_diag@L{idx}", "attn", m=Q, k=Q, n=s.head_dim,
                      batch=batch * nc * nh, is_attention=True))
        ops.append(Op(f"ssd_state@L{idx}", "attn", m=s.d_state, k=Q, n=s.head_dim,
                      batch=batch * nc * nh, is_attention=True))
        ops.append(Op(f"ssd_off@L{idx}", "attn", m=Q, k=s.d_state, n=s.head_dim,
                      batch=batch * nc * nh, is_attention=True))
        ops.append(Op(f"ssd_decay@L{idx}", "ew",
                      ew_ops=6 * batch * nc * nh * Q, sfu_ops=batch * nc * nh * Q))
    else:
        state_bytes = batch * nh * s.head_dim * s.d_state * BYTES
        # state update + output: elementwise + tiny GEMVs over the state
        ops.append(Op(f"ssm_step@L{idx}", "ew",
                      ew_ops=6 * batch * nh * s.head_dim * s.d_state,
                      sfu_ops=2 * batch * nh,
                      stream_bytes=2 * state_bytes))
    ops.append(Op(f"ssm_gate@L{idx}", "ew", ew_ops=6 * T * di, sfu_ops=T))
    ops.append(Op(f"ssm_out@L{idx}", "matmul", m=T, k=di, n=d,
                  stream_bytes=di * d))
    return ops


def _shared_attn_ops(cfg, l_q: int, batch: int, phase: str, ctx: int) -> List[Op]:
    """Zamba2 shared block, invoked n_layers // every times."""
    h = cfg.hybrid
    n_inv = cfg.n_layers // h.shared_attn_every
    d_in = cfg.d_model * (2 if h.concat_embedding else 1)
    nh = h.shared_attn_n_heads
    dh = d_in // nh
    T = batch * l_q
    ops: List[Op] = []
    ops.append(Op("shared_qkvo", "matmul", m=T, k=d_in, n=4 * d_in,
                  stream_bytes=4 * d_in * d_in, count=n_inv))
    if phase == "prefill":
        avg = (ctx + 1) // 2
        ops.append(Op("shared_scores", "attn", m=l_q, k=dh, n=avg,
                      batch=batch * nh, count=n_inv, is_attention=True))
        ops.append(_softmax_op("shared_softmax", batch * nh * l_q, avg, count=n_inv))
        ops.append(Op("shared_av", "attn", m=l_q, k=avg, n=dh,
                      batch=batch * nh, count=n_inv, is_attention=True))
    else:
        kv = batch * ctx * nh * dh * BYTES
        ops.append(Op("shared_scores", "attn", m=1, k=dh, n=ctx,
                      batch=batch * nh, stream_bytes=kv, count=n_inv,
                      is_attention=True))
        ops.append(_softmax_op("shared_softmax", batch * nh, ctx, count=n_inv))
        ops.append(Op("shared_av", "attn", m=1, k=ctx, n=dh,
                      batch=batch * nh, stream_bytes=kv, count=n_inv,
                      is_attention=True))
    ops.append(Op("shared_ffn", "matmul", m=T, k=d_in, n=cfg.d_ff, batch=3,
                  stream_bytes=3 * d_in * cfg.d_ff, count=n_inv))
    ops.append(Op("shared_down", "matmul", m=T, k=d_in, n=cfg.d_model,
                  stream_bytes=d_in * cfg.d_model, count=n_inv))
    return ops


# ---------------------------------------------------------------------------
# summaries
# ---------------------------------------------------------------------------

def total_flops(ops: List[Op]) -> int:
    return sum(o.flops for o in ops)


def total_stream(ops: List[Op]) -> int:
    return sum(o.total_stream for o in ops)
