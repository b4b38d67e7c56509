"""HALO phase scheduler: ops x mapping x hardware -> TTFT / TPOT / E2E / energy.

Decode cost grows affinely with context length t (KV-cache streaming and
softmax width are linear in t, everything else constant), so the total decode
time over L_out tokens is computed EXACTLY from the two endpoints:

    sum_{t=L_in..L_in+L_out-1} cost(t) = L_out * (cost(t0) + cost(t1)) / 2

This is the paper's evaluation loop (Figs. 5-10) in closed form.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engines import make_engines
from repro_torch.core.hardware import DEFAULT_HW, HaloHardware
from repro_torch.core.mapping import Mapping, get_mapping
from repro_torch.core.opgraph import Op, decode_ops, prefill_ops


@dataclass
class PhaseResult:
    seconds: float = 0.0
    joules: float = 0.0
    by_engine_s: Dict[str, float] = field(default_factory=dict)
    by_op_kind_s: Dict[str, float] = field(default_factory=dict)


@dataclass
class RunResult:
    """One (model, mapping, L_in, L_out, batch) evaluation."""

    model: str
    mapping: str
    l_in: int
    l_out: int
    batch: int
    ttft: float                    # prefill seconds
    tpot: float                    # mean seconds per output token
    decode_total: float
    prefill_energy: float
    decode_energy: float
    prefill_detail: PhaseResult = None
    decode_detail: PhaseResult = None

    @property
    def e2e(self) -> float:
        return self.ttft + self.decode_total

    @property
    def energy(self) -> float:
        return self.prefill_energy + self.decode_energy


def _phase_cost(ops: List[Op], mapping: Mapping, engines, phase: str
                ) -> PhaseResult:
    res = PhaseResult()
    for op in ops:
        eng = mapping.engine_for(op, phase)
        c = engines[eng].cost(op)
        res.seconds += c.seconds
        res.joules += c.joules
        res.by_engine_s[eng] = res.by_engine_s.get(eng, 0.0) + c.seconds
        base = op.name.split("@")[0]
        res.by_op_kind_s[base] = res.by_op_kind_s.get(base, 0.0) + c.seconds
    return res


def evaluate(cfg: ModelConfig, mapping_name: str, l_in: int, l_out: int,
             batch: int = 1, hw: Optional[HaloHardware] = None) -> RunResult:
    mapping = get_mapping(mapping_name)
    hw = (hw or DEFAULT_HW).with_wordlines(mapping.wordlines)
    engines = make_engines(hw)

    pre = _phase_cost(prefill_ops(cfg, l_in, batch), mapping, engines, "prefill")

    # decode: affine in context -> exact trapezoid over [t0, t1]
    t0 = max(l_in, 1)
    t1 = l_in + max(l_out, 1) - 1
    d0 = _phase_cost(decode_ops(cfg, t0, batch), mapping, engines, "decode")
    d1 = _phase_cost(decode_ops(cfg, t1, batch), mapping, engines, "decode")
    tpot = (d0.seconds + d1.seconds) / 2.0
    decode_total = tpot * l_out
    decode_energy = (d0.joules + d1.joules) / 2.0 * l_out

    mid = PhaseResult(
        seconds=tpot, joules=(d0.joules + d1.joules) / 2.0,
        by_engine_s={k: (d0.by_engine_s.get(k, 0) + d1.by_engine_s.get(k, 0)) / 2
                     for k in set(d0.by_engine_s) | set(d1.by_engine_s)},
        by_op_kind_s={k: (d0.by_op_kind_s.get(k, 0) + d1.by_op_kind_s.get(k, 0)) / 2
                      for k in set(d0.by_op_kind_s) | set(d1.by_op_kind_s)})

    return RunResult(
        model=cfg.name, mapping=mapping_name, l_in=l_in, l_out=l_out,
        batch=batch, ttft=pre.seconds, tpot=tpot, decode_total=decode_total,
        prefill_energy=pre.joules, decode_energy=decode_energy,
        prefill_detail=pre, decode_detail=mid)


# ---------------------------------------------------------------------------
# sweeps + geometric means (the paper's headline numbers)
# ---------------------------------------------------------------------------

# (L_in, L_out) grid used for the Fig. 7/8 style end-to-end comparisons;
# the paper spans 128..10K for both axes.
DEFAULT_GRID = [
    (512, 128), (2048, 128), (8192, 128),
    (512, 2048), (2048, 2048), (8192, 2048),
]

PREFILL_LENGTHS = [512, 2048, 8192]             # Fig. 5 TTFT sweep (paper: 512-8192)
DECODE_GRID = [(512, 512), (2048, 512), (2048, 2048), (8192, 512)]  # Fig. 6


def geomean(xs: List[float]) -> float:
    import math
    xs = [max(x, 1e-30) for x in xs]
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def gmean_speedup(cfg: ModelConfig, base: str, ours: str,
                  grid=None, metric: str = "e2e", batch: int = 1,
                  hw: Optional[HaloHardware] = None) -> float:
    """Geometric-mean ratio base/ours over the (L_in, L_out) grid."""
    grid = grid or DEFAULT_GRID
    ratios = []
    for l_in, l_out in grid:
        a = evaluate(cfg, base, l_in, l_out, batch, hw)
        b = evaluate(cfg, ours, l_in, l_out, batch, hw)
        get = {
            "e2e": lambda r: r.e2e,
            "ttft": lambda r: r.ttft,
            "tpot": lambda r: r.tpot,
            "energy": lambda r: r.energy,
            "prefill_energy": lambda r: r.prefill_energy,
            "decode_energy": lambda r: r.decode_energy / max(r.l_out, 1),
        }[metric]
        ratios.append(get(a) / get(b))
    return geomean(ratios)
