"""Device groups for disaggregated serving (port of ``phase_device_groups``
of src/repro/launch/mesh.py; the port has no mesh)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def phase_device_groups(devices: Optional[Sequence[torch.device]] = None
                        ) -> Tuple[List[torch.device], List[torch.device]]:
    """Split the devices into (prefill_group, decode_group) for
    disaggregated serving (``serving/executor.DisaggregatedExecutor``).

    HALO dedicates DIFFERENT hardware to each phase (CiM prefill, CiD
    decode); here the analogue is disjoint halves of the device list —
    prefill takes the first half, decode the second.  ``devices`` defaults
    to the visible CUDA devices, or ``[cpu]`` without a card.  A single
    device cannot split, so both groups share it: program pinning changes
    nothing while the handoff accounting (the 2.5D-link analogue) still
    runs for real, which keeps streams equal colocated vs disaggregated."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = ([torch.device("cuda", i) for i in range(n)]
                   or [torch.device("cpu")])
    devs = [torch.device(d) for d in devices]
    if len(devs) < 2:
        return devs, devs
    half = len(devs) // 2
    return devs[:half], devs[half:]
