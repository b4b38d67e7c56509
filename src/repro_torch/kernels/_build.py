"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/kernels/`` at the
root of the checkout, and loaded with ``ctypes``.  The build happens at
first use and is keyed by a hash of every source in ``csrc/`` and the
compiler flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  ``build_all`` starts one ``nvcc`` per source at once.
``ptxas -v``'s report of each library's kernels (registers, stack, spills)
is kept beside it and read by ``ptxas_usage``.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")
KERNELS = ("paged_decode_attention", "packed_prefill_attention", "gemv_int8",
           "paged_decode_attention_q4", "flash_attention", "decode_attention",
           "ssd_chunk", "gemm_cim")

# torch dtype -> the dtype code of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# ctypes signatures of the C entry points: pointers and the stream are
# c_void_p (a bare Python int would be cut to 32 bits), sizes c_int
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "paged_decode_attention":
        [I, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, F,
         P],
    "packed_prefill_attention":
        [I, I, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, F, P],
    "gemv_int8": [I, I, I, P, P, P, P, P, P, I, I, I, I, I, P],
    "paged_decode_attention_q4":
        [I, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I,
         I, F, P],
    "flash_attention": [I, I, P, P, P, P, I, I, I, I, I, I, I, F, P],
    "decode_attention":
        [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, F, P],
    "ssd_chunk": [I, I, P, P, P, P, P, P, P, I, I, I, I, I, P],
    "gemm_cim": [I, I, I, P, P, P, I, I, I, P],
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _so_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def _start(name: str) -> subprocess.Popen:
    """Start one nvcc for ``csrc/<name>.cu`` into a temporary file that
    ``_finish`` renames into place (a half-written library is never
    loaded)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _so_path(name).with_suffix(f".tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    _log_path(name).write_text(out)
    tmp.replace(_so_path(name))


def _log_path(name: str) -> Path:
    return _so_path(name).with_suffix(".ptxas")


def parse_ptxas(text: str) -> List[dict]:
    """Each kernel's registers, stack frame and spill bytes in the report
    of ``nvcc -Xptxas -v``; device functions without a register line (not
    kernels) are left out."""
    rows: List[dict] = []
    for line in text.splitlines():
        if "Function properties for" in line:
            rows.append(dict(kernel=line.split(" for ", 1)[1].strip()))
        elif rows and "spill stores" in line:
            stack, stores, loads = map(int, re.findall(r"(\d+) bytes",
                                                       line)[:3])
            rows[-1].update(stack=stack, spill_stores=stores,
                            spill_loads=loads)
        elif rows and re.search(r"Used \d+ registers", line):
            rows[-1]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return [r for r in rows if "registers" in r]


def ptxas_usage(name: str) -> List[dict]:
    """``parse_ptxas`` of the report kept when ``csrc/<name>.cu`` was
    built (built first if it is not)."""
    function(name)
    return parse_ptxas(_log_path(name).read_text())


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_so_path(name)))
    fn = getattr(lib, name)
    fn.argtypes = SIGNATURES[name]
    fn.restype = ctypes.c_int
    return lib


def build_all(names: Iterable[str] = KERNELS) -> List[str]:
    """Build every named kernel that is not built yet, one ``nvcc`` per
    source, all started together; then load them.  Returns the names that
    were compiled (empty when every library was already built)."""
    with _lock:
        todo = [n for n in names if n not in _libs
                and not _so_path(n).exists()]
        procs = [(n, _start(n)) for n in todo]
        errors = []
        for n, p in procs:
            try:
                _finish(n, p)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in names:
            if n not in _libs:
                _libs[n] = _load(n)
        return todo


def function(name: str):
    """The C entry point ``name`` of ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        build_all([name])
    return getattr(_libs[name], name)


def check_cuda(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def aligned16(*tensors) -> bool:
    """Whether every base address is 16-byte aligned, as TMA needs."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def check_tensors(name: str, tensors: Sequence[torch.Tensor],
                  dtype: torch.dtype, device: torch.device) -> None:
    """What every kernel wrapper refuses rather than passes to the card:
    a tensor on another device, of another dtype, or not contiguous."""
    for i, t in enumerate(tensors):
        if t.device != device:
            raise ValueError(f"{name}: argument {i} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: argument {i} has dtype {t.dtype}, "
                             f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
