"""Execution engines: latency + energy of one Op on one HALO compute unit.

Latency model (per engine):

  CiD   t = max(flops / peak_ops, stream_bytes / internal_bw)
        GEMV (m==batch small) is stream-bound: the 41 TB/s aggregate in-bank
        bandwidth is the service rate.  GEMM is capped at the 41 Tops the
        bank-level MACs provide (weights are register-held and reused across
        the input vectors resident in the 4 KB SRAM buffer).

  CiM   t = max(flops / peak_ops, stream_bytes / fill_bw)
        GEMM is compute-bound at the analog-array rate (ADC-pipelined);
        GEMV is fill-bound: every weight byte must cross the 1 TB/s GB path.
        64-wordline mode halves peak_ops and doubles ADC energy.

  SA    same shape as CiM with digital-systolic constants (HALO-SA).

  VU    elementwise/softmax/norm ops on the logic-die vector units;
        exp/rsqrt on the SFU at 1/4 rate.

The max() encodes the double-buffered overlap of fills with compute that the
paper inherits from COMET: whichever pipeline stage is slower hides the
other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.hardware import HaloHardware
from repro_torch.core.opgraph import Op


@dataclass(frozen=True)
class Cost:
    seconds: float
    joules: float

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.seconds + other.seconds, self.joules + other.joules)


ZERO = Cost(0.0, 0.0)


class Engine:
    name = "abstract"

    def cost(self, op: Op) -> Cost:
        raise NotImplementedError


class CiDEngine(Engine):
    name = "cid"

    def __init__(self, hw: HaloHardware):
        self.c = hw.cid

    def cost(self, op: Op) -> Cost:
        t_compute = op.flops / self.c.peak_ops
        t_stream = op.total_stream / self.c.internal_bw
        t = max(t_compute, t_stream)
        e = (op.flops * self.c.e_mac
             + op.total_stream * self.c.e_bank_read
             + op.total_stream * self.c.e_buffer)
        return Cost(t, e)


class CiMEngine(Engine):
    name = "cim"

    def __init__(self, hw: HaloHardware):
        self.c = hw.cim

    def cost(self, op: Op) -> Cost:
        t_compute = op.flops / self.c.peak_ops
        t_fill = op.total_stream / self.c.fill_bw
        t = max(t_compute, t_fill)
        e = (op.flops * self.c.e_per_op()
             + op.total_stream * self.c.e_fill
             + op.total_stream * self.c.e_buffer)
        return Cost(t, e)


class SystolicEngine(Engine):
    name = "sa"

    def __init__(self, hw: HaloHardware):
        self.c = hw.sa

    def cost(self, op: Op) -> Cost:
        t = max(op.flops / self.c.peak_ops, op.total_stream / self.c.fill_bw)
        e = op.flops * self.c.e_mac + op.total_stream * self.c.e_fill
        return Cost(t, e)


class VectorEngine(Engine):
    name = "vu"

    def __init__(self, hw: HaloHardware):
        self.c = hw.vu
        self.hw = hw

    def cost(self, op: Op) -> Cost:
        t = (op.ew_ops * op.count / self.c.peak_ops
             + op.sfu_ops * op.count / self.c.peak_sfu_ops)
        t = max(t, op.total_stream / self.hw.cim.gb_bw)
        e = ((op.ew_ops + op.sfu_ops) * op.count * self.c.e_op
             + op.total_stream * self.c.e_sram)
        return Cost(t, e)


def make_engines(hw: HaloHardware) -> Dict[str, Engine]:
    return {
        "cid": CiDEngine(hw),
        "cim": CiMEngine(hw),
        "sa": SystolicEngine(hw),
        "vu": VectorEngine(hw),
    }
