"""Weight-only int8 quantization for serving (port of
src/repro/serving/quantized_weights.py).

HALO stores weights in int8 (crossbar bit-slices / bank MACs); the serving
analogue is weight-only quantization: every matrix consumed through
``layers.matmul`` is stored int8 with a per-output-channel f32 scale, and
decode-shaped products read the int8 bytes directly in the int8 GEMV
kernel (``kernels/gemv_cid.py``).

Only >=2D float leaves of at least ``min_size`` elements named in
``MATMUL_LEAVES`` are quantized; MoE expert banks, norms, embeddings and
the LM head stay in their dtype.  A quantized leaf becomes
``{"q": int8 [..., K, N], "scale": f32 [..., N]}``.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

# leaf names consumed via layers.matmul (safe to quantize)
MATMUL_LEAVES = (
    "wq", "wk", "wv", "wo", "wq_a", "wq_b", "wkv_a",
    "wi_gate", "wi_up", "in_proj", "out_proj", "down",
)


def quantize_weight(w: torch.Tensor):
    """Per-output-channel symmetric int8 over the last dim's columns, from
    f32 as the reference does (``torch.round`` rounds half to even, like
    ``jnp.round``).  A stacked leaf [L, K, N] is quantized one layer at a
    time — the same numbers, with one layer's f32 copy in memory at once."""
    if w.ndim > 2:
        parts = [quantize_weight(w[i]) for i in range(w.shape[0])]
        return {"q": torch.stack([p["q"] for p in parts]),
                "scale": torch.stack([p["scale"] for p in parts])}
    wf = w.float()
    amax = wf.abs().amax(dim=-2)                              # [N]
    scale = amax.clamp(min=1e-8) / 127.0
    q = torch.round(wf / scale[None, :]).clamp_(-127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_weight(wq) -> torch.Tensor:
    return wq["q"].float() * wq["scale"][..., None, :]


def quantize_params(params: Any, min_size: int = 1 << 14) -> Any:
    """Quantize every matmul-consumed weight leaf; leave the rest (the
    tree is rebuilt; leaves that stay are shared, not copied)."""

    def walk(node, path: Tuple[str, ...]):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),))
                              for i, v in enumerate(node))
        # MoE expert banks reuse the ffn leaf names but are consumed by the
        # expert einsums, not layers.matmul — keep them dense
        if (isinstance(node, torch.Tensor) and node.ndim >= 2
                and node.numel() >= min_size and path
                and path[-1] in MATMUL_LEAVES and "moe" not in path
                and node.is_floating_point()):
            return quantize_weight(node)
        return node

    return walk(params, ())
