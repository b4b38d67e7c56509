from repro_torch.core.hardware import DEFAULT_HW, HaloHardware
from repro_torch.core.mapping import MAPPINGS, Mapping, get_mapping
from repro_torch.core.opgraph import Op, decode_ops, prefill_ops, total_flops, total_stream
from repro_torch.core.scheduler import (
    DEFAULT_GRID,
    RunResult,
    evaluate,
    geomean,
    gmean_speedup,
)

__all__ = [
    "DEFAULT_HW", "HaloHardware",
    "MAPPINGS", "Mapping", "get_mapping",
    "Op", "decode_ops", "prefill_ops", "total_flops", "total_stream",
    "DEFAULT_GRID", "RunResult", "evaluate", "geomean", "gmean_speedup",
]
