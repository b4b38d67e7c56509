"""Weights from the reference onto the port.

The reference's ``init_params`` pytree (src/repro/models/transformer.py:162)
and the port's parameters share one layout: ``embed`` [V, d], ``lm_head``
[d, V] (absent when embeddings are tied), ``final_norm`` {"scale"}, and per
run ``runs[r]`` with every leaf stacked [n_layers, ...] — ``ln1``/``ln2``
{"scale"}, ``attn`` {"wq","wk","wv","wo"[, "q_norm","k_norm"]} and ``ffn``
{"wi_gate","wi_up","wo"} for an attention run; ``ln1`` and ``ssm``
{"in_proj","conv_w","conv_b","A_log","D","dt_bias","norm_scale","out_proj"}
(and ``ln2``/``ffn`` where the model has an FFN) for a Mamba-2 run, whose
A_log, D and dt_bias the reference keeps in f32 whatever the model dtype
(src/repro/models/ssm.py:24).  A weight the reference quantized
(``quantize_params``) is a ``{"q": int8, "scale": f32}`` leaf and keeps
those dtypes.  The converter takes that pytree as numpy arrays (the caller
converts the JAX arrays), checks it, and copies each leaf onto the device.
No checkpoint is ever downloaded.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

_RUN_KEYS = {"ln1": {"scale"}, "ln2": {"scale"},
             "attn": {"wq", "wk", "wv", "wo"}, "ffn": {"wi_gate", "wi_up", "wo"}}
_SSM_RUN_KEYS = {"ln1": {"scale"},
                 "ssm": {"in_proj", "conv_w", "conv_b", "A_log", "D",
                         "dt_bias", "norm_scale", "out_proj"}}
# the SSM leaves the reference keeps in f32 in a model of any dtype
_F32_LEAVES = {"A_log", "D", "dt_bias"}


def _leaf(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes bf16: via f32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))    # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def _tree(x, device, dtype):
    if isinstance(x, dict) and set(x) == {"q", "scale"}:
        # an int8-quantized weight leaf keeps its int8 values and f32 scales
        return {k: _leaf(v, device, None) for k, v in x.items()}
    if isinstance(x, dict):
        return {k: _tree(v, device, None if k in _F32_LEAVES else dtype)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, device, dtype) for v in x]
    return _leaf(x, device, dtype)


def params_from_jax(np_pytree: Any, device,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """The reference's parameter pytree (numpy leaves) as the port's
    parameters on ``device`` (float leaves cast to ``dtype`` when given;
    the int8 values and f32 scales of quantized leaves are kept)."""
    missing = {"embed", "final_norm", "runs"} - set(np_pytree)
    if missing:
        raise ValueError(f"params_from_jax: missing {sorted(missing)}")
    for r, run in enumerate(np_pytree["runs"]):
        need = dict(_SSM_RUN_KEYS if "ssm" in run else _RUN_KEYS)
        if "ssm" in run and "ffn" in run:
            need.update(ln2=_RUN_KEYS["ln2"], ffn=_RUN_KEYS["ffn"])
        for key, leaves in need.items():
            if key not in run or not leaves <= set(run[key]):
                raise ValueError(
                    f"params_from_jax: runs[{r}][{key!r}] needs "
                    f"{sorted(leaves)} (only dense attention and Mamba-2 "
                    "runs are ported so far)")
    return _tree(dict(np_pytree), device, dtype)
