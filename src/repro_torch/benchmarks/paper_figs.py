"""One benchmark per paper table/figure, on the analytical HALO model.

Each function returns rows of (name, value, unit, paper_value) — run.py
prints them as CSV.  paper_value of '' means the figure publishes a curve,
not a single scalar; the row is the reproduction datapoint.
"""

from __future__ import annotations

from typing import List, Tuple

from repro_torch.configs.base import get_config
from repro_torch.core.scheduler import (
    DECODE_GRID,
    DEFAULT_GRID,
    PREFILL_LENGTHS,
    evaluate,
    geomean,
    gmean_speedup,
)

Row = Tuple[str, float, str, str]

llama = get_config("llama2-7b")
qwen = get_config("qwen3-8b")


def fig4_breakdown() -> List[Row]:
    """Execution-time split of LLaMA-2 7B on the CiM engine (Fig. 4)."""
    from repro_torch.core.engines import make_engines
    from repro_torch.core.hardware import DEFAULT_HW
    from repro_torch.core.mapping import get_mapping
    from repro_torch.core.opgraph import decode_ops, prefill_ops
    from repro_torch.core.scheduler import _phase_cost

    engines = make_engines(DEFAULT_HW)
    m = get_mapping("full_cim")
    rows: List[Row] = []
    pre = _phase_cost(prefill_ops(llama, 2048, 1), m, engines, "prefill")
    dec = _phase_cost(decode_ops(llama, 2048, 1), m, engines, "decode")
    for phase, pr in (("prefill", pre), ("decode", dec)):
        for eng, s in sorted(pr.by_engine_s.items()):
            rows.append((f"fig4.{phase}.engine_{eng}_frac",
                         s / pr.seconds, "frac", ""))
    return rows


def fig5_ttft() -> List[Row]:
    rows: List[Row] = []
    for L in PREFILL_LENGTHS:
        cid = evaluate(llama, "full_cid", L, 1)
        cim = evaluate(llama, "full_cim", L, 1)
        rows.append((f"fig5a.ttft_cid_L{L}", cid.ttft, "s", ""))
        rows.append((f"fig5a.ttft_cim_L{L}", cim.ttft, "s", ""))
    g = geomean([evaluate(llama, "full_cid", L, 1).ttft
                 / evaluate(llama, "full_cim", L, 1).ttft
                 for L in PREFILL_LENGTHS])
    rows.append(("fig5a.gmean_ttft_speedup_cim", g, "x", "6.0"))
    ge = geomean([evaluate(llama, "full_cid", L, 1).prefill_energy
                  / evaluate(llama, "full_cim", L, 1).prefill_energy
                  for L in PREFILL_LENGTHS])
    rows.append(("fig5b.gmean_prefill_energy_ratio", ge, "x", "2.6"))
    return rows


def fig6_tpot() -> List[Row]:
    rows: List[Row] = []
    for li, lo in DECODE_GRID:
        cid = evaluate(llama, "full_cid", li, lo)
        cim = evaluate(llama, "full_cim", li, lo)
        rows.append((f"fig6a.tpot_cid_L{li}_{lo}", cid.tpot, "s", ""))
        rows.append((f"fig6a.tpot_cim_L{li}_{lo}", cim.tpot, "s", ""))
    g = geomean([evaluate(llama, "full_cim", li, lo).tpot
                 / evaluate(llama, "full_cid", li, lo).tpot
                 for li, lo in DECODE_GRID])
    rows.append(("fig6a.gmean_tpot_speedup_cid", g, "x", "39"))
    ge = geomean([evaluate(llama, "full_cim", li, lo).decode_energy
                  / evaluate(llama, "full_cid", li, lo).decode_energy
                  for li, lo in DECODE_GRID])
    rows.append(("fig6b.gmean_decode_energy_ratio", ge, "x", "3.9"))
    return rows


def fig7_e2e() -> List[Row]:
    rows: List[Row] = []
    for model, tag in ((llama, "llama2"), (qwen, "qwen3")):
        for li, lo in DEFAULT_GRID:
            base = max(evaluate(model, m, li, lo).e2e
                       for m in ("halo1", "halo2", "cent", "attacc1",
                                 "attacc2"))
            for m in ("halo1", "halo2", "cent", "attacc1", "attacc2"):
                r = evaluate(model, m, li, lo)
                rows.append((f"fig7.{tag}.norm_e2e.{m}.L{li}_{lo}",
                             r.e2e / base, "frac", ""))
        rows.append((f"fig7.{tag}.gmean_e2e_attacc1_over_halo1",
                     gmean_speedup(model, "attacc1", "halo1"), "x", "18"))
        rows.append((f"fig7.{tag}.gmean_e2e_cent_over_halo1",
                     gmean_speedup(model, "cent", "halo1"), "x", "2.4"))
    rows.append(("fig7.gmean_ttft_cent_over_halo1",
                 gmean_speedup(llama, "cent", "halo1", metric="ttft"),
                 "x", "6.54"))
    rows.append(("fig7.gmean_tpot_attacc1_over_halo1",
                 gmean_speedup(llama, "attacc1", "halo1", metric="tpot"),
                 "x", "34"))
    rows.append(("fig7.gmean_e2e_halo2_over_halo1",
                 gmean_speedup(llama, "halo2", "halo1"), "x", "1.10"))
    return rows


def fig8_energy() -> List[Row]:
    rows: List[Row] = []
    rows.append(("fig8.gmean_E_attacc1_over_halo1",
                 gmean_speedup(llama, "attacc1", "halo1", metric="energy"),
                 "x", "2.0"))
    rows.append(("fig8.gmean_E_cent_over_halo1",
                 gmean_speedup(llama, "cent", "halo1", metric="energy"),
                 "x", "1.8"))
    rows.append(("fig8.gmean_E_halo2_over_halo1",
                 gmean_speedup(llama, "halo2", "halo1", metric="energy"),
                 "x", ""))
    for li, lo in DEFAULT_GRID:
        for m in ("halo1", "cent", "attacc1"):
            r = evaluate(llama, m, li, lo)
            rows.append((f"fig8.prefill_E_frac.{m}.L{li}_{lo}",
                         r.prefill_energy / r.energy, "frac", ""))
    return rows


def fig9_batch() -> List[Row]:
    rows: List[Row] = []
    l_in, l_out = 128, 2048
    for bs in (1, 4, 16, 64):
        for m in ("halo1", "cent", "attacc1"):
            r = evaluate(llama, m, l_in, l_out, batch=bs)
            rows.append((f"fig9.e2e.{m}.bs{bs}", r.e2e, "s", ""))
    return rows


def fig10_systolic() -> List[Row]:
    rows: List[Row] = []
    rows.append(("fig10.gmean_e2e_sa_over_cim1",
                 gmean_speedup(llama, "halo_sa", "halo1"), "x", "1.3"))
    halo2_vs_sa = gmean_speedup(llama, "halo_sa", "halo2")
    rows.append(("fig10.gmean_e2e_sa_over_cim2", halo2_vs_sa, "x", "1.2"))
    return rows


ALL = [fig4_breakdown, fig5_ttft, fig6_tpot, fig7_e2e, fig8_energy,
       fig9_batch, fig10_systolic]
