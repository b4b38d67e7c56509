"""Phase-aware mapping strategies (paper Table II).

A mapping assigns every Op to an engine, per phase.  Non-GEMM ops (norms,
softmax, rope, activations) always run on the logic-die vector units in every
strategy — the strategies differ only in where the GEMM/GEMV work goes.

  halo1    prefill GEMMs -> CiM (128 wordlines), ALL decode GEMVs -> CiD.
  halo2    same with 64 wordlines (non-ideality mitigation; 2x ADC energy).
  cent     everything -> CiD in both phases (CENT / fully-CiD).
  attacc1  prefill -> CiM(128wl); decode: ONLY attention -> CiD, the rest
           (QKV/proj/FFN/LM-head GEMVs) stays on CiM.
  attacc2  same with 64 wordlines.
  full_cim everything -> CiM (the Section V-B extreme).
  halo_sa  phase-aware like halo1 but CiM replaced by an iso-area digital
           systolic array (Section V-D, i.e. a NeuPIM-like design).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

from repro_torch.core.opgraph import Op

NON_GEMM = ("ew", "softmax", "norm")


@dataclass(frozen=True)
class Mapping:
    name: str
    wordlines: int                              # CiM wordlines (latency/energy)
    prefill_engine: Callable[[Op], str]
    decode_engine: Callable[[Op], str]

    def engine_for(self, op: Op, phase: str) -> str:
        if op.kind in NON_GEMM:
            return "vu"
        sel = self.prefill_engine if phase == "prefill" else self.decode_engine
        return sel(op)


def _const(engine: str) -> Callable[[Op], str]:
    return lambda op: engine


def _attacc_decode(op: Op) -> str:
    return "cid" if op.is_attention else "cim"


MAPPINGS: Dict[str, Mapping] = {
    "halo1": Mapping("halo1", 128, _const("cim"), _const("cid")),
    "halo2": Mapping("halo2", 64, _const("cim"), _const("cid")),
    "cent": Mapping("cent", 128, _const("cid"), _const("cid")),
    "full_cid": Mapping("full_cid", 128, _const("cid"), _const("cid")),
    "full_cim": Mapping("full_cim", 128, _const("cim"), _const("cim")),
    "attacc1": Mapping("attacc1", 128, _const("cim"), _attacc_decode),
    "attacc2": Mapping("attacc2", 64, _const("cim"), _attacc_decode),
    "halo_sa": Mapping("halo_sa", 128, _const("sa"), _const("cid")),
}


def get_mapping(name: str) -> Mapping:
    return MAPPINGS[name]
