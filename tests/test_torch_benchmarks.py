"""The port's benchmark runner on the CPU: its copy of the HALO analytic
model (``repro_torch.core``) and of ``paper_figs`` give exactly the
reference's numbers (the same Python arithmetic, so ``==``), its
``kernel_micro`` prints every row of the reference's under the port's
names, and a suite that fails makes the runner fail."""

import ast
import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.core import mapping as ref_mapping
from repro.core import scheduler as ref_scheduler
from repro_torch.benchmarks import kernel_micro, paper_figs, run
from repro_torch.configs import get_config
from repro_torch.core import mapping, scheduler

ROOT = Path(__file__).resolve().parents[1]
MODELS = ("llama2-7b", "qwen3-8b")
# the Fig. 5 prefill sweep and the Fig. 6 decode grid
POINTS = ([(L, 1) for L in scheduler.PREFILL_LENGTHS]
          + list(scheduler.DECODE_GRID))


def _reference_module(name):
    """A module of the reference's top-level ``benchmarks`` folder, loaded
    from its file (the folder is not a package on the path)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_benchmarks_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _memoize_evaluate(monkeypatch, scheduler_module, *users):
    """Within one test, each (model, mapping, L_in, L_out, batch, hw) is
    evaluated once per package: ``evaluate`` is pure, and the figures and
    geometric means repeat the same points many times."""
    fn, cache = scheduler_module.evaluate, {}

    def evaluate(cfg, mapping_name, l_in, l_out, batch=1, hw=None):
        key = (id(cfg), mapping_name, l_in, l_out, batch, id(hw))
        if key not in cache:
            cache[key] = fn(cfg, mapping_name, l_in, l_out, batch, hw)
        return cache[key]

    for mod in (scheduler_module, *users):
        monkeypatch.setattr(mod, "evaluate", evaluate)


def test_grids_are_the_reference_grids():
    assert scheduler.PREFILL_LENGTHS == ref_scheduler.PREFILL_LENGTHS
    assert scheduler.DECODE_GRID == ref_scheduler.DECODE_GRID
    assert scheduler.DEFAULT_GRID == ref_scheduler.DEFAULT_GRID
    assert sorted(mapping.MAPPINGS) == sorted(ref_mapping.MAPPINGS)


@pytest.mark.parametrize("model", MODELS)
def test_evaluate_and_gmean_speedup_equal_the_reference(model, monkeypatch):
    """Every mapping at every point of the Fig. 5 sweep and the Fig. 6
    grid: the same result, field for field; and each mapping's geometric
    mean over those points against halo1, for every metric."""
    cfg, ref_cfg = get_config(model), ref_config(model)
    for m in sorted(ref_mapping.MAPPINGS):
        for l_in, l_out in POINTS:
            ours = scheduler.evaluate(cfg, m, l_in, l_out)
            want = ref_scheduler.evaluate(ref_cfg, m, l_in, l_out)
            assert dataclasses.asdict(ours) == dataclasses.asdict(want), (
                m, l_in, l_out)
            assert (ours.e2e, ours.energy) == (want.e2e, want.energy)
    _memoize_evaluate(monkeypatch, scheduler)
    _memoize_evaluate(monkeypatch, ref_scheduler)
    for m in sorted(ref_mapping.MAPPINGS):
        for metric in ("e2e", "ttft", "tpot", "energy", "prefill_energy",
                       "decode_energy"):
            assert (scheduler.gmean_speedup(cfg, m, "halo1", POINTS, metric)
                    == ref_scheduler.gmean_speedup(ref_cfg, m, "halo1",
                                                   POINTS, metric)), (
                m, metric)


def test_paper_figs_rows_equal_the_reference(monkeypatch):
    ref_figs = _reference_module("paper_figs")
    _memoize_evaluate(monkeypatch, scheduler, paper_figs)
    _memoize_evaluate(monkeypatch, ref_scheduler, ref_figs)
    assert ([fn.__name__ for fn in paper_figs.ALL]
            == [fn.__name__ for fn in ref_figs.ALL])
    for ours, want in zip(paper_figs.ALL, ref_figs.ALL):
        assert ours() == want(), ours.__name__


def _reference_kernel_rows():
    """Every row name of the reference's kernel_micro, in order, read from
    its source, under the port's names: the analytic ``v5e_`` rows become
    ``h100_`` rows, the timed ``cpu_interpret_us`` rows ``cpu_us``."""
    tree = ast.parse((ROOT / "benchmarks" / "kernel_micro.py").read_text())
    names = [n.value for n in ast.walk(tree)
             if isinstance(n, ast.Constant) and isinstance(n.value, str)
             and n.value.startswith("kernel.")]
    names.sort(key=lambda s: next(n.lineno for n in ast.walk(tree)
                                  if isinstance(n, ast.Constant)
                                  and n.value == s))
    return [s.replace(".v5e_", ".h100_").replace(".cpu_interpret_us",
                                                 ".cpu_us") for s in names]


def test_runner_prints_every_kernel_row_on_the_cpu(capsys):
    assert run.main(["--device", "cpu", "--only", "kernel_micro"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,value,unit,paper"
    rows = [line.split(",") for line in lines[1:]]
    want = _reference_kernel_rows()
    assert len(want) == 16
    assert [r[0] for r in rows] == want
    assert all(math.isfinite(float(r[1])) for r in rows)


def test_a_failing_suite_fails_the_runner(monkeypatch, capsys):
    def boom():
        raise RuntimeError("suite failed")
    monkeypatch.setattr(paper_figs, "ALL", [paper_figs.fig4_breakdown, boom])
    with pytest.raises(RuntimeError, match="suite failed"):
        run.main(["--only", "paper_figs"])
    out = capsys.readouterr().out
    assert "fig4.prefill" in out and "ERROR" not in out


def test_kernel_rows_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--only", "kernel_micro"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_micro.bench_kernels()
