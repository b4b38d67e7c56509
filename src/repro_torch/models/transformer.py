"""Model assembly for serving (port of the dense-attention, Mamba-2 and
Zamba2 parts of src/repro/models/transformer.py): whole-prompt prefill,
and one-token decode and packed chunked prefill over either the paged pool
or the dense per-slot decode arena; a padded [N, C] chunk batch over the
paged pool (``forward_chunk``: the speculative verify window, and prefill
with ``packed_prefill=False``).

The layer stack is a sequence of RUNS — maximal groups of layers with one
block structure — whose parameters are stacked along a leading layer axis,
in the reference's pytree layout.  The reference scans each run with
``jax.lax.scan``; here a Python loop walks layer views ``runs[r][...][l]``.

Supported plans: all-attention, dense-FFN, single-codebook, no MLA — the
paper's llama2-7b and qwen3-8b — all-SSM (mamba2-2.7b), and the Zamba2
hybrid (zamba2-2.7b: runs of Mamba-2 layers with ONE shared attention
block, its weights stored once in ``params["shared_attn"]``, applied after
each run to ``concat([h, embed0])``).  SSM and hybrid plans serve only on
the dense arena with whole-prompt prefill, as in the reference.  The other
families arrive with ROADMAP queue A, item 11.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    dense_init,
    embed_init,
    ffn,
    matmul,
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
    """Runs of an all-attention, all-SSM or Zamba2 plan (the reference's
    ``build_plan``, src/repro/models/transformer.py:63, for the families
    this port serves): an SSM layer of a model without an FFN (d_ff == 0)
    has ffn kind "none"; a hybrid is ``shared_attn_every``-layer SSM runs,
    each followed by a shared-attention run (no layers of its own), and a
    last SSM run of the layers left over."""
    check_supported(cfg)
    runs: List[RunSpec] = []
    if cfg.family == "hybrid":
        every = cfg.hybrid.shared_attn_every
        n_groups = cfg.n_layers // every
        for g in range(n_groups):
            runs.append(RunSpec("ssm", every, "none", layer_start=g * every))
            runs.append(RunSpec("shared_attn", 0, "none"))
        rem = cfg.n_layers - n_groups * every
        if rem:
            runs.append(RunSpec("ssm", rem, "none",
                                layer_start=n_groups * every))
        return runs
    kinds = cfg.layer_kinds()

    def sig(i: int) -> Tuple[str, str]:
        k = kinds[i]
        return (k, "none" if (k == "ssm" and cfg.d_ff == 0) else "dense")

    i = 0
    while i < cfg.n_layers:
        kind, ffn_kind = sig(i)
        j = i
        while j < cfg.n_layers and sig(j) == (kind, ffn_kind):
            j += 1
        window, theta = 0, cfg.attn.rope_theta
        if kind == "attn_local":
            window = cfg.attn.sliding_window
            if cfg.attn.rope_local_theta:
                theta = cfg.attn.rope_local_theta
        runs.append(RunSpec("attn" if kind.startswith("attn") else "ssm",
                            j - i, ffn_kind, window, theta, layer_start=i))
        i = j
    return runs


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a model family this port does not serve yet, and for a
    config whose family and sub-configs disagree (a "hybrid" without
    ``hybrid.enabled``, an SSM family without ``ssm.enabled``, or the
    other way round)."""
    if (cfg.family not in ("dense", "ssm", "hybrid") or cfg.mla.enabled
            or cfg.moe.enabled or cfg.n_codebooks > 1
            or cfg.frontend != "none"
            or (cfg.family == "hybrid") != cfg.hybrid.enabled
            or (cfg.family in ("ssm", "hybrid")) != cfg.ssm.enabled):
        raise NotImplementedError(
            f"{cfg.name}: only dense all-attention models, Mamba-2 and "
            "Zamba2 are ported so far (other architectures: ROADMAP queue "
            "A, item 11)")


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


def _shared_geometry(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(width, heads, head dim) of the Zamba2 shared block: it reads
    ``concat([h, embed0])`` (2 d_model wide) when ``concat_embedding``,
    with H = Hkv heads of width / H."""
    h = cfg.hybrid
    d_in = cfg.d_model * (2 if h.concat_embedding else 1)
    return d_in, h.shared_attn_n_heads, d_in // h.shared_attn_n_heads


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device) -> List[Any]:
    """The dense decode arena, zeros (the reference's ``init_cache``,
    src/repro/models/transformer.py:208): per attention run {"k", "v"} of
    [L, batch, cache_len(run, seq_len), Hkv, D] in the model dtype; per SSM
    run {"conv": [L, batch, d_conv - 1, conv_dim] in the model dtype,
    "state": [L, batch, H, P, N] f32}; per shared-attention run {"k", "v"}
    of [batch, seq_len, H, dh] in the model dtype, batch leading and no
    layer axis.  On the ``meta`` device it allocates nothing
    (``cache_specs``)."""
    dtype = torch_dtype(cfg.dtype)
    caches: List[Any] = []
    for run in build_plan(cfg):
        if run.kind == "ssm":
            s = cfg.ssm
            conv_dim = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
            caches.append({
                "conv": torch.zeros((run.n_layers, batch, s.d_conv - 1,
                                     conv_dim), dtype=dtype, device=device),
                "state": torch.zeros((run.n_layers, batch,
                                      s.n_heads(cfg.d_model), s.head_dim,
                                      s.d_state), dtype=torch.float32,
                                     device=device)})
            continue
        if run.kind == "shared_attn":
            _, nh, dh = _shared_geometry(cfg)
            shape = (batch, seq_len, nh, dh)
        else:
            shape = (run.n_layers, batch, cache_len(run, seq_len),
                     cfg.n_kv_heads, cfg.d_head)
        caches.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)})
    return caches


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> List[Any]:
    """``init_cache``'s tree as tensors on the ``meta`` device: shapes and
    dtypes, nothing allocated (the reference's ``cache_specs``,
    src/repro/models/transformer.py:243)."""
    return init_cache(cfg, batch, seq_len, "meta")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random weights drawn from ``generator`` directly on ``device``, with
    the reference's pytree layout, shapes and init scales
    (src/repro/models/transformer.py:119,144,162): truncated-normal fan-in
    matmul weights, 0.02-normal embedding and LM head, unit norms; an SSM
    layer's block as ``ssm.ssm_init`` draws it; a hybrid's shared block
    drawn once into ``params["shared_attn"]``, each shared run's
    ``runs[r]`` empty."""
    dtype = torch_dtype(cfg.dtype)
    d, V = cfg.d_model, padded_vocab(cfg)
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def ffn_stack(L, width):
        return {"wi_gate": empty(L, width, cfg.d_ff),
                "wi_up": empty(L, width, cfg.d_ff),
                "wo": empty(L, cfg.d_ff, width)}

    params: Params = {"embed": embed_init(empty(V, d), generator)}
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(empty(d, V), generator)
    params["final_norm"] = {"scale": ones(d)}
    runs = []
    for run in build_plan(cfg):
        L = run.n_layers
        if run.kind == "shared_attn":
            if "shared_attn" not in params:
                params["shared_attn"] = _shared_attn_init(cfg, generator,
                                                          device)
            runs.append({})                              # weights shared
            continue
        if run.kind == "ssm":
            rp = {"ln1": {"scale": ones(L, d)},
                  "ssm": _stacked(L, lambda: ssm_mod.ssm_init(
                      d, cfg.ssm, dtype, generator, device))}
            if run.ffn_kind == "dense":
                ffn_p = ffn_stack(L, d)
                _dense_init_all(ffn_p.values(), generator)
                rp.update(ln2={"scale": ones(L, d)}, ffn=ffn_p)
            runs.append(rp)
            continue
        ffn_p = ffn_stack(L, d)
        attn = {"wq": empty(L, d, H * Dh), "wk": empty(L, d, Hkv * Dh),
                "wv": empty(L, d, Hkv * Dh), "wo": empty(L, H * Dh, d)}
        _dense_init_all(list(attn.values()) + list(ffn_p.values()),
                        generator)
        if cfg.attn.qk_norm:
            attn["q_norm"] = ones(L, Dh)
            attn["k_norm"] = ones(L, Dh)
        runs.append({"ln1": {"scale": ones(L, d)}, "attn": attn,
                     "ln2": {"scale": ones(L, d)}, "ffn": ffn_p})
    params["runs"] = runs
    return params


def _shared_attn_init(cfg: ModelConfig, generator: torch.Generator,
                      device) -> Params:
    """The Zamba2 shared block (the reference's ``_shared_attn_init``,
    src/repro/models/transformer.py:144) at width d_in =
    ``_shared_geometry``'s: norms over d_in, attention d_in -> H x dh ->
    d_in, a d_in -> d_ff -> d_in FFN, and ``down`` [d_in, d_model], a
    normal draw over sqrt(d_in)."""
    dtype = torch_dtype(cfg.dtype)
    d_in, nh, dh = _shared_geometry(cfg)

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    attn = {"wq": empty(d_in, nh * dh), "wk": empty(d_in, nh * dh),
            "wv": empty(d_in, nh * dh), "wo": empty(nh * dh, d_in)}
    ffn_p = {"wi_gate": empty(d_in, cfg.d_ff), "wi_up": empty(d_in, cfg.d_ff),
             "wo": empty(cfg.d_ff, d_in)}
    for w in list(attn.values()) + list(ffn_p.values()):
        dense_init(w, generator)
    down = torch.empty((d_in, cfg.d_model), dtype=torch.float32,
                       device=device)
    torch.nn.init.normal_(down, 0.0, 1.0, generator=generator)
    ones = torch.ones((d_in,), dtype=dtype, device=device)
    return {"ln1": {"scale": ones}, "attn": attn,
            "ln2": {"scale": ones.clone()}, "ffn": ffn_p,
            "down": down.to(dtype) / math.sqrt(d_in)}


def _dense_init_all(stacks, generator) -> None:
    """``dense_init`` every layer of every stacked [L, in, out] matrix."""
    for stack in stacks:
        for layer in stack:
            dense_init(layer, generator)


def _stacked(L: int, init_layer) -> Params:
    """``init_layer()``'s leaves for L layers stacked on a leading axis,
    filled one layer at a time (one layer's draw in memory beside the
    stack, not L of them)."""
    first = init_layer()
    out = {k: torch.empty((L,) + tuple(v.shape), dtype=v.dtype,
                          device=v.device) for k, v in first.items()}
    for l in range(L):
        layer = first if l == 0 else init_layer()
        for k, v in layer.items():
            out[k][l] = v
    return out


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


def _attn_layer_prefill(cfg, run, lp, x, positions):
    """One attention layer of a whole-prompt prefill: (x, (k, v))."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    a, kv = attn_mod.attn_prefill(lp["attn"], h, positions,
                                  **_attn_kw(cfg, run))
    return _ffn_residual(cfg, lp, x + a), kv


def _attn_layer_decode(cfg, run, lp, x, cache, pos, write=None):
    """One attention layer of a dense-arena one-token decode step;
    ``cache`` is the layer's arena view, updated in place."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    a, _, _ = attn_mod.attn_decode(lp["attn"], h, cache["k"], cache["v"], pos,
                                   write=write, **_attn_kw(cfg, run))
    return _ffn_residual(cfg, lp, x + a)


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


def _attn_layer_chunk_paged(cfg, run, lp, x, cache, bt, view):
    """One attention layer of a padded chunk batch against the pool
    (``view``: the run's ``attn_mod.chunk_paged_view``)."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    a, cache = attn_mod.attn_chunk_paged(
        lp["attn"], h, None, None, None, cache, bt, view=view,
        **_attn_kw(cfg, run))
    return _ffn_residual(cfg, lp, x + a), cache


def _attn_layer_chunk_packed(cfg, run, lp, x, seg, cache, view):
    """One attention layer of a packed prefill stream against the dense
    arena (``view``: the run's ``attn_mod.arena_packed_view``)."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    a, _, _ = attn_mod.attn_chunk_packed(lp["attn"], h, seg, cache["k"],
                                         cache["v"], view=view,
                                         **_attn_kw(cfg, run))
    return _ffn_residual(cfg, lp, x + a)


def _ssm_layer_prefill(cfg, run, lp, x):
    """One SSM layer of a whole-prompt prefill: (x, (conv_state, state))."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    o, states = ssm_mod.ssm_prefill(lp["ssm"], h, cfg.d_model, cfg.ssm)
    x = x + o
    if run.ffn_kind == "dense":
        x = _ffn_residual(cfg, lp, x)
    return x, states


def _ssm_layer_decode(cfg, run, lp, x, cache, rows=None):
    """One SSM layer of a dense-arena one-token decode step: every row is
    computed, and ``cache`` (the layer's arena view) takes the new conv
    window and state at ``rows`` only (every row when None), in place."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    o, conv, state = ssm_mod.ssm_decode(lp["ssm"], h, cache["conv"],
                                        cache["state"], cfg.d_model, cfg.ssm)
    for key, new in (("conv", conv), ("state", state)):
        if rows is None:
            cache[key].copy_(new)
        else:
            cache[key][rows] = new[rows].to(cache[key].dtype)
    x = x + o
    if run.ffn_kind == "dense":
        x = _ffn_residual(cfg, lp, x)
    return x


def _shared_attn_apply(cfg, sp, x, embed0, *, positions=None, cache=None,
                       pos=None, write=None):
    """The Zamba2 shared block (the reference's ``_shared_attn_apply``,
    src/repro/models/transformer.py:540) on ``inp = concat([x, embed0])``:
    rmsnorm, attention at H = Hkv heads of dh (window 0, no qk-norm), the
    residual, rmsnorm, the FFN and the residual on the d_in-wide stream,
    then ``x + inp @ down``.  With ``positions`` it is a whole-prompt
    prefill and returns (x, (k, v)), K/V [B, T, H, dh]; with ``cache`` (a
    shared run's {"k", "v"} of [B, S, H, dh]) a one-token decode step that
    writes its K/V at ``write`` (an ``arena_write_index``) in place and
    returns (x, None)."""
    _, nh, dh = _shared_geometry(cfg)
    inp = torch.cat([x, embed0], dim=-1) if cfg.hybrid.concat_embedding else x
    kw = dict(n_heads=nh, n_kv_heads=nh, d_head=dh,
              theta=cfg.attn.rope_theta, window=0)
    y = rmsnorm(sp["ln1"], inp, cfg.norm_eps)
    if cache is None:
        a, kv = attn_mod.attn_prefill(sp["attn"], y, positions, **kw)
    else:
        a, _, _ = attn_mod.attn_decode(sp["attn"], y, cache["k"], cache["v"],
                                       pos, write=write, **kw)
        kv = None
    inp = inp + a
    y = rmsnorm(sp["ln2"], inp, cfg.norm_eps)
    inp = inp + ffn(sp["ffn"], y, cfg.act)
    return x + matmul(inp, sp["down"]), kv


def _pool_geometry(cache_run, run: RunSpec) -> Tuple[int, int, int]:
    n_pages, P = cache_run["k"].shape[1], cache_run["k"].shape[2]
    return attn_mod._paged_ring(run.window, n_pages, P), P, n_pages


# ---------------------------------------------------------------------------
# full-model passes
# ---------------------------------------------------------------------------

def forward(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            *, phase: str = "decode", cache: Optional[List[Any]] = None,
            pos=None, block_tables: Optional[List[Any]] = None,
            slot_mask=None):
    """phase == "prefill": batch["tokens"] [B,T], positions 0..T-1.
        Returns (logits [B,1,V] f32 of the LAST position only, cache, 0.0):
        per run the layout of ``_pack_prefill_cache`` (attention K/V in
        ring order; SSM conv windows and states; a shared run's K/V).
    phase == "decode": batch["tokens"] [B,1], ``pos`` [B] (or a scalar)
        the position of each new token.  Returns (logits [B,1,V] f32,
        cache, 0.0), ``cache`` updated in place.  With ``block_tables``
        (one [B, W] int32 table per run) ``cache`` is the PAGED pool from
        ``serving.kv_pool.KVPool``; without, it is the dense arena of
        ``init_cache``, and only the rows of ``slot_mask`` [B] bool (every
        row when None) write their new K/V, conv window and SSM state; a
        shared-attention run reads and writes its [B, S, H, dh] leaves.

    The train phase arrives with ROADMAP queue A, item 12."""
    if phase == "prefill":
        kvs: List[List[Any]] = [[] for _ in build_plan(cfg)]
        logits = _prefill(params, cfg, batch["tokens"],
                          lambda r, l, k, v: kvs[r].append((k, v)))
        T = batch["tokens"].shape[-1]
        caches = [_pack_prefill_cache(run, kv, T)
                  for run, kv in zip(build_plan(cfg), kvs)]
        return logits, caches, 0.0
    if phase != "decode":
        raise NotImplementedError(
            f"phase={phase!r}: the train phase arrives with ROADMAP queue A, "
            "item 12")
    x = embed_tokens(params, cfg, batch["tokens"])
    embed0 = x                            # the shared block's second half
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).long().expand(B)
    rows = (None if slot_mask is None
            else torch.nonzero(torch.as_tensor(slot_mask,
                                               device=x.device)).flatten())
    for r, run in enumerate(build_plan(cfg)):
        if run.kind == "shared_attn":
            # a shared run's K/V are [B, S, H, dh]: S on axis 1
            write = attn_mod.arena_write_index(pos, cache[r]["k"].shape[1],
                                               rows)
            x, _ = _shared_attn_apply(cfg, params["shared_attn"], x, embed0,
                                      cache=cache[r], pos=pos, write=write)
            continue
        if run.kind == "ssm":
            for l in range(run.n_layers):
                x = _ssm_layer_decode(cfg, run,
                                      layer_view(params["runs"][r], l), x,
                                      layer_view(cache[r], l), rows)
            continue
        if block_tables is not None:
            bt = block_tables[r]
            R, P, n_pages = _pool_geometry(cache[r], run)
            write = attn_mod.paged_write_index(bt, pos, R, P, n_pages)
        else:
            write = attn_mod.arena_write_index(pos, cache[r]["k"].shape[2],
                                               rows)
        for l in range(run.n_layers):
            lp, lc = layer_view(params["runs"][r], l), layer_view(cache[r], l)
            if block_tables is not None:
                x, _ = _attn_layer_decode_paged(cfg, run, lp, x, lc, bt, pos,
                                                write)
            else:
                x = _attn_layer_decode(cfg, run, lp, x, lc, pos, write)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x), cache, 0.0


def _prefill(params, cfg, tokens, on_kv) -> torch.Tensor:
    """The whole-prompt forward: every layer at positions 0..T-1, each
    layer's cache leaves handed to ``on_kv(run index, layer, a, b)`` as they
    are made — K and V [B,T,Hkv,D] of an attention layer (and of a shared
    run's one application, layer 0), the conv window [B, d_conv-1,
    conv_dim] and state [B,H,P,N] of an SSM layer — and the last
    position's logits [B,1,V] f32 returned."""
    x = embed_tokens(params, cfg, tokens)
    embed0 = x
    B, T = x.shape[0], x.shape[1]
    positions = torch.arange(T, device=x.device).expand(B, T)
    for r, run in enumerate(build_plan(cfg)):
        if run.kind == "shared_attn":
            x, (a, b) = _shared_attn_apply(cfg, params["shared_attn"], x,
                                           embed0, positions=positions)
            on_kv(r, 0, a, b)
            continue
        for l in range(run.n_layers):
            lp = layer_view(params["runs"][r], l)
            if run.kind == "ssm":
                x, (a, b) = _ssm_layer_prefill(cfg, run, lp, x)
            else:
                x, (a, b) = _attn_layer_prefill(cfg, run, lp, x, positions)
            on_kv(r, l, a, b)
    x = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return lm_logits(params, cfg, x)


def _ring_order(run: RunSpec, x, T: int):
    """A prefill's K or V [B, T, ...] as the decode ring holds it: the last
    cache_len(run, T) positions, rolled so index s holds the position p
    with p % S == s (the reference's ``_pack_prefill_cache``)."""
    S = cache_len(run, T)
    x = x[:, T - S:]
    if run.window > 0 and T > S and T % S != 0:
        x = torch.roll(x, shifts=T % S, dims=1)
    return x


def _pack_prefill_cache(run: RunSpec, kvs, T: int):
    """One run's per-layer prefill leaves as the decode cache layout:
    {"k", "v"} of [L, B, cache_len(run, T), Hkv, D] in ring order for an
    attention run, {"conv", "state"} of [L, B, ...] for an SSM run, {"k",
    "v"} of [B, T, H, dh] for a shared-attention run."""
    if run.kind == "shared_attn":
        (k, v), = kvs
        return {"k": k, "v": v}
    if run.kind == "ssm":
        return {"conv": torch.stack([c for c, _ in kvs]),
                "state": torch.stack([s for _, s in kvs])}
    return {"k": torch.stack([_ring_order(run, k, T) for k, _ in kvs]),
            "v": torch.stack([_ring_order(run, v, T) for _, v in kvs])}


def prefill_into_arena(params: Params, cfg: ModelConfig, batch, slot: int,
                       cache: List[Any]):
    """Whole-prompt prefill of one request (batch["tokens"] [1, T]) spliced
    into arena slot ``slot``: each layer's cache leaves go straight into
    the arena as they are made — K/V in ring order, their last min(T_ring,
    R) entries at positions [0, pl) of the slot (a shared run's at [0, pl)
    of its batch-leading leaves); an SSM layer's conv window and state
    whole — so the arena ends as the reference's
    ``splice_arena`` (src/repro/models/transformer.py:842) leaves it,
    without a stacked copy of every layer.  Returns (last_logits [1, 1, V]
    f32, cache) — the arena updated in place."""
    T = batch["tokens"].shape[-1]
    plan = build_plan(cfg)

    def write(r, l, a, b):
        if plan[r].kind == "ssm":
            for key, x in (("conv", a), ("state", b)):
                cache[r][key][l, slot] = x[0].to(cache[r][key].dtype)
            return
        if plan[r].kind == "shared_attn":
            for key, x in (("k", a), ("v", b)):
                arena = cache[r][key]                        # [B, S, H, dh]
                pl = min(x.shape[1], arena.shape[1])
                arena[slot, :pl] = x[0, x.shape[1] - pl:]
            return
        for key, x in (("k", a), ("v", b)):
            arena = cache[r][key]
            x = _ring_order(plan[r], x, T)
            pl = min(x.shape[1], arena.shape[2])
            arena[l, slot, :pl] = x[0, x.shape[1] - pl:]

    return _prefill(params, cfg, batch["tokens"], write), cache


def splice_arena(cfg: ModelConfig, cache: List[Any], piece: List[Any],
                 slot: int) -> List[Any]:
    """Write a one-request prefill cache (``forward(phase="prefill")``'s,
    batch 1) into arena slot ``slot`` in place and return the arena (the
    reference's ``splice_arena``, src/repro/models/transformer.py:842): an
    SSM run's conv window and state whole; the last min(T, S) K/V entries
    of an attention run (batch axis 1, sequence axis 2) and of a shared run
    (batch axis 0, sequence axis 1) at positions [0, pl)."""
    for run, arena, p in zip(build_plan(cfg), cache, piece):
        for key, a in arena.items():
            pc = p[key]
            if run.kind == "ssm":
                a[:, slot] = pc[:, 0].to(a.dtype)
                continue
            ax = 2 if run.kind == "attn" else 1
            pl = min(pc.shape[ax], a.shape[ax])
            pc = pc.narrow(ax, pc.shape[ax] - pl, pl).to(a.dtype)
            if run.kind == "attn":
                a[:, slot, :pl] = pc[:, 0]
            else:
                a[slot, :pl] = pc[0]
    return cache


def pad_cache(cfg: ModelConfig, cache: List[Any], prompt_len: int,
              max_len: int) -> List[Any]:
    """A prefill cache (length ``prompt_len``) grown with zeros to
    ``max_len`` positions so decoding can append (the reference's
    ``pad_cache``, src/repro/models/transformer.py:889): an attention run's
    leaves on axis 2 up to cache_len(run, max_len), a shared run's on axis
    1; SSM states are length-independent and kept as they are."""
    out = []
    for run, c in zip(build_plan(cfg), cache):
        if run.kind == "ssm" or c is None:
            out.append(c)
            continue
        target = cache_len(run, max_len)
        axis = 2 if run.kind == "attn" else 1

        def grow(x):
            if x.shape[axis] >= target:
                return x
            shape = list(x.shape)
            shape[axis] = target - x.shape[axis]
            return torch.cat([x, x.new_zeros(shape)], dim=axis)

        out.append({k: grow(x) for k, x in c.items()})
    return out


def prefill(params: Params, cfg: ModelConfig, batch):
    """Whole-prompt prefill: (last logits [B, 1, V] f32, cache)."""
    logits, cache, _ = forward(params, cfg, batch, phase="prefill")
    return logits, cache


def decode_step(params: Params, cfg: ModelConfig, batch, cache, pos):
    """One decode step over ``cache`` (updated in place): (logits, cache)."""
    logits, cache, _ = forward(params, cfg, batch, phase="decode",
                               cache=cache, pos=pos)
    return logits, cache


def forward_chunk_packed(params: Params, cfg: ModelConfig, tokens, starts,
                         offsets, lengths, slots, cache: List[Any],
                         block_tables: Optional[List[Any]] = None,
                         pack_align: int = 8):
    """PACKED chunked prefill: one flat token stream, into the paged pool
    (one [B, W] table per run in ``block_tables``) or, without tables, into
    the dense arena of ``init_cache``.

    tokens: [T] — N segments (one per request chunk) laid out back to back
    at ``starts`` [N] (non-decreasing, aligned to ``pack_align``; pad
    segments carry start == T).  Segment ``n`` holds prompt tokens
    [offsets[n], offsets[n]+lengths[n]) of the request in slot ``slots[n]``.

    Returns (last_logits [N, 1, V] f32, cache): logits of each segment's
    last valid position — meaningful only for segments completing their
    prompt.  The pool is updated in place.  ``pack_align`` is accepted for
    the reference's signature; the kernel serves any alignment.
    """
    tokens = torch.as_tensor(tokens).long()
    T = tokens.shape[-1]
    x = embed_tokens(params, cfg, tokens[None])                  # [1, T, d]
    seg = attn_mod.make_packed_segs(starts, offsets, lengths, slots, T)
    for r, run in enumerate(build_plan(cfg)):
        if run.kind != "attn":
            raise NotImplementedError(
                f"packed prefill over {run.kind!r} runs; gate on "
                "supports_chunked_prefill()")
        if block_tables is None:
            B, R = cache[r]["k"].shape[1], cache[r]["k"].shape[2]
            view = attn_mod.arena_packed_view(seg, B, R)
        else:
            bt = block_tables[r]
            R, P, n_pages = _pool_geometry(cache[r], run)
            bt_rows = bt[seg.slots.clamp(0, bt.shape[0] - 1)]
            write = attn_mod.packed_write_index(seg, bt_rows, R, P, n_pages,
                                                bt.shape[0])
        for l in range(run.n_layers):
            lp, lc = layer_view(params["runs"][r], l), layer_view(cache[r], l)
            if block_tables is None:
                x = _attn_layer_chunk_packed(cfg, run, lp, x, seg, lc, view)
            else:
                x, _ = _attn_layer_chunk_packed_paged(cfg, run, lp, x, seg,
                                                      lc, bt, write)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    last = (seg.starts + seg.lengths - 1).clamp(0, T - 1)        # [N]
    return lm_logits(params, cfg, x[0, last][:, None, :]), cache


def forward_chunk(params: Params, cfg: ModelConfig, tokens, offsets,
                  lengths, slots, cache: List[Any],
                  block_tables: Optional[List[Any]] = None,
                  return_all_logits: bool = False):
    """Chunked prefill of a padded batch, writing K/V into the paged pool
    (the reference's ``forward_chunk``, src/repro/models/transformer.py:725,
    with ``block_tables``; without them, over the dense arena, it is ROADMAP
    queue A, item 11).

    tokens: [N, C] — N chunk rows padded to C tokens; row ``n`` holds
    tokens [offsets[n], offsets[n] + lengths[n]) of the request in slot
    ``slots[n]`` (pad rows carry slot >= B and drop their writes).

    Returns (last_logits [N, 1, V] f32, cache): the logits of each row's
    last valid position.  With ``return_all_logits`` the logits of EVERY
    window position come back instead ([N, C, V]) — the speculative verify
    program scores each draft token against the position that predicts
    it; positions past a row's length are garbage the caller masks.  The
    pool is updated in place."""
    if block_tables is None:
        raise NotImplementedError(
            "forward_chunk over the dense arena (the padded [N, C] "
            "attn_chunk): ROADMAP queue A, item 11")
    tokens = torch.as_tensor(tokens).long()
    x = embed_tokens(params, cfg, tokens)                        # [N, C, d]
    N, C = x.shape[0], x.shape[1]
    lengths = torch.as_tensor(lengths, device=x.device).long()
    for r, run in enumerate(build_plan(cfg)):
        if run.kind != "attn":
            raise NotImplementedError(
                f"chunked prefill over {run.kind!r} runs; gate on "
                "supports_chunked_prefill()")
        bt = block_tables[r]
        R, P, n_pages = _pool_geometry(cache[r], run)
        view = attn_mod.chunk_paged_view(offsets, lengths, slots, bt, C,
                                         ring=R, page_size=P,
                                         n_pages=n_pages, window=run.window)
        for l in range(run.n_layers):
            lp, lc = layer_view(params["runs"][r], l), layer_view(cache[r], l)
            x, _ = _attn_layer_chunk_paged(cfg, run, lp, x, lc, bt, view)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if return_all_logits:
        return lm_logits(params, cfg, x), cache
    last = (lengths - 1).clamp(0, C - 1)
    h_last = x[torch.arange(N, device=x.device), last][:, None, :]
    return lm_logits(params, cfg, h_last), cache
