"""Model assembly for the serving main path (port of the dense-attention,
paged part of src/repro/models/transformer.py).

The layer stack is a sequence of RUNS — maximal groups of layers with one
block structure — whose parameters are stacked along a leading layer axis,
in the reference's pytree layout.  The reference scans each run with
``jax.lax.scan``; here a Python loop walks layer views ``runs[r][...][l]``.

Supported plans: all-attention, dense-FFN, single-codebook, no MLA — the
paper's llama2-7b and qwen3-8b.  The other families arrive with ROADMAP
queue A, item 11.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (
    dense_init,
    embed_init,
    ffn,
    matmul_f32,
    rmsnorm,
    torch_dtype,
)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# run plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RunSpec:
    kind: str                 # "attn" | "ssm" | "shared_attn"
    n_layers: int             # 0 for shared_attn
    ffn_kind: str = "dense"   # "dense" | "moe" | "none"
    window: int = 0           # 0 = full attention
    theta: float = 10000.0
    layer_start: int = 0      # first absolute layer index of this run


def build_plan(cfg: ModelConfig) -> List[RunSpec]:
    """Runs of an all-attention dense plan (the reference's ``build_plan``
    restricted to the families this slice serves)."""
    check_supported(cfg)
    kinds = cfg.layer_kinds()
    runs: List[RunSpec] = []
    i = 0
    while i < cfg.n_layers:
        j = i
        while j < cfg.n_layers and kinds[j] == kinds[i]:
            j += 1
        window, theta = 0, cfg.attn.rope_theta
        if kinds[i] == "attn_local":
            window = cfg.attn.sliding_window
            if cfg.attn.rope_local_theta:
                theta = cfg.attn.rope_local_theta
        runs.append(RunSpec("attn", j - i, "dense", window, theta,
                            layer_start=i))
        i = j
    return runs


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a model family this slice does not serve yet."""
    if (cfg.family not in ("dense",) or cfg.mla.enabled or cfg.moe.enabled
            or cfg.ssm.enabled or cfg.hybrid.enabled or cfg.n_codebooks > 1
            or cfg.frontend != "none"):
        raise NotImplementedError(
            f"{cfg.name}: only dense all-attention models are ported so far "
            "(other architectures: ROADMAP queue A, item 11)")


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // 256) * 256


def cache_len(run: RunSpec, seq_len: int) -> int:
    if run.window > 0:
        return min(run.window, seq_len)
    return seq_len


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """True iff every run can prefill incrementally against the pool."""
    return all(run.kind == "attn" for run in build_plan(cfg))


def supports_paged(cfg: ModelConfig) -> bool:
    """True iff every run can live in the paged block pool."""
    return all(run.kind == "attn" for run in build_plan(cfg))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random weights drawn from ``generator`` directly on ``device``, with
    the reference's pytree layout, shapes and init scales
    (src/repro/models/transformer.py:119,162): truncated-normal fan-in
    matmul weights, 0.02-normal embedding and LM head, unit norms."""
    dtype = torch_dtype(cfg.dtype)
    d, V = cfg.d_model, padded_vocab(cfg)
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    params: Params = {"embed": embed_init(empty(V, d), generator)}
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(empty(d, V), generator)
    params["final_norm"] = {"scale": ones(d)}
    runs = []
    for run in build_plan(cfg):
        L = run.n_layers
        attn = {"wq": empty(L, d, H * Dh), "wk": empty(L, d, Hkv * Dh),
                "wv": empty(L, d, Hkv * Dh), "wo": empty(L, H * Dh, d)}
        ffn_p = {"wi_gate": empty(L, d, cfg.d_ff),
                 "wi_up": empty(L, d, cfg.d_ff),
                 "wo": empty(L, cfg.d_ff, d)}
        for stack in list(attn.values()) + list(ffn_p.values()):
            for layer in stack:
                dense_init(layer, generator)
        if cfg.attn.qk_norm:
            attn["q_norm"] = ones(L, Dh)
            attn["k_norm"] = ones(L, Dh)
        runs.append({"ln1": {"scale": ones(L, d)}, "attn": attn,
                     "ln2": {"scale": ones(L, d)}, "ffn": ffn_p})
    params["runs"] = runs
    return params


def layer_view(tree, layer: int):
    """The parameters (or pool leaves) of one layer of a stacked run, as
    views: ``tree`` with every leaf indexed at ``layer`` on axis 0."""
    if isinstance(tree, dict):
        return {k: layer_view(v, layer) for k, v in tree.items()}
    return tree[layer]


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens):
    """tokens: [B,T] int -> [B,T,d]."""
    return params["embed"][tokens.long()]


def lm_logits(params, cfg: ModelConfig, h):
    """h: [B,T,d] -> f32 logits [B,T,V]."""
    if cfg.tie_embeddings:
        return matmul_f32(h, params["embed"].t())
    return matmul_f32(h, params["lm_head"])


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------

def _attn_kw(cfg: ModelConfig, run: RunSpec):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                d_head=cfg.d_head, theta=run.theta, window=run.window,
                softcap=cfg.attn.logit_softcap, qk_norm=cfg.attn.qk_norm)


def _ffn_residual(cfg, lp, x):
    h = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + ffn(lp["ffn"], h, cfg.act)


def _attn_layer_decode_paged(cfg, run, lp, x, cache, bt, pos, write=None):
    """One attention layer of a paged one-token decode step; ``cache`` is
    the layer's pool view, updated in place.  A quantized pool (``k_scale``
    pages) decodes through the int4 path when its pages are uint8 nibble
    pairs and the int8 path otherwise."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if "k_scale" in cache:
        decode = (attn_mod.attn_decode_q4_paged
                  if cache["k"].dtype == torch.uint8
                  else attn_mod.attn_decode_q8_paged)
    else:
        decode = attn_mod.attn_decode_paged
    a, cache = decode(lp["attn"], h, cache, bt, pos, write=write,
                      **_attn_kw(cfg, run))
    return _ffn_residual(cfg, lp, x + a), cache


def _attn_layer_chunk_packed_paged(cfg, run, lp, x, seg, cache, bt,
                                   write=None):
    """One attention layer of a packed prefill stream against the pool."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    a, cache = attn_mod.attn_chunk_packed_paged(
        lp["attn"], h, seg, cache, bt, write=write, **_attn_kw(cfg, run))
    return _ffn_residual(cfg, lp, x + a), cache


def _pool_geometry(cache_run, run: RunSpec) -> Tuple[int, int, int]:
    n_pages, P = cache_run["k"].shape[1], cache_run["k"].shape[2]
    return attn_mod._paged_ring(run.window, n_pages, P), P, n_pages


# ---------------------------------------------------------------------------
# full-model passes
# ---------------------------------------------------------------------------

def forward(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            *, phase: str = "decode", cache: Optional[List[Any]] = None,
            pos=None, block_tables: Optional[List[Any]] = None):
    """Paged one-token decode: batch["tokens"] [B,1], ``cache`` the PAGED
    pool from ``serving.kv_pool.KVPool`` (one dict of [L, n_pages, P, Hkv,
    D] leaves per run), ``block_tables`` one [B, W] int32 table per run,
    ``pos`` [B] the position of each new token.  Returns (logits [B,1,V]
    f32, cache, 0.0); the pool is updated in place.

    The train/prefill phases and the dense arena arrive with ROADMAP queue
    A, items 11-12."""
    if phase != "decode" or block_tables is None:
        raise NotImplementedError(
            "only the paged decode phase is ported (dense arena, prefill "
            "and train phases: ROADMAP queue A, items 11-12)")
    x = embed_tokens(params, cfg, batch["tokens"])
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).long().expand(B)
    for r, run in enumerate(build_plan(cfg)):
        bt = block_tables[r]
        R, P, n_pages = _pool_geometry(cache[r], run)
        write = attn_mod.paged_write_index(bt, pos, R, P, n_pages)
        for l in range(run.n_layers):
            x, _ = _attn_layer_decode_paged(
                cfg, run, layer_view(params["runs"][r], l), x,
                layer_view(cache[r], l), bt, pos, write)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x), cache, 0.0


def forward_chunk_packed(params: Params, cfg: ModelConfig, tokens, starts,
                         offsets, lengths, slots, cache: List[Any],
                         block_tables: Optional[List[Any]] = None,
                         pack_align: int = 8):
    """PACKED chunked prefill into the paged pool: one flat token stream.

    tokens: [T] — N segments (one per request chunk) laid out back to back
    at ``starts`` [N] (non-decreasing, aligned to ``pack_align``; pad
    segments carry start == T).  Segment ``n`` holds prompt tokens
    [offsets[n], offsets[n]+lengths[n]) of the request in slot ``slots[n]``.

    Returns (last_logits [N, 1, V] f32, cache): logits of each segment's
    last valid position — meaningful only for segments completing their
    prompt.  The pool is updated in place.  ``pack_align`` is accepted for
    the reference's signature; the kernel serves any alignment.
    """
    if block_tables is None:
        raise NotImplementedError("packed prefill into the dense arena: "
                                  "later slice (ROADMAP queue A, item 11)")
    tokens = torch.as_tensor(tokens).long()
    T = tokens.shape[-1]
    x = embed_tokens(params, cfg, tokens[None])                  # [1, T, d]
    seg = attn_mod.make_packed_segs(starts, offsets, lengths, slots, T)
    for r, run in enumerate(build_plan(cfg)):
        bt = block_tables[r]
        R, P, n_pages = _pool_geometry(cache[r], run)
        bt_rows = bt[seg.slots.clamp(0, bt.shape[0] - 1)]
        write = attn_mod.packed_write_index(seg, bt_rows, R, P, n_pages,
                                            bt.shape[0])
        for l in range(run.n_layers):
            x, _ = _attn_layer_chunk_packed_paged(
                cfg, run, layer_view(params["runs"][r], l), x, seg,
                layer_view(cache[r], l), bt, write)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    last = (seg.starts + seg.lengths - 1).clamp(0, T - 1)        # [N]
    return lm_logits(params, cfg, x[0, last][:, None, :]), cache
