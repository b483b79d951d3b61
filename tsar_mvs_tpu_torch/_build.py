"""Build and load the CUDA kernels under ``csrc/``.

The sources compile with nvcc (one process per source, in parallel)
into one shared library with a plain C interface,
``build/tsar_mvs_tpu_torch/libtsar_kernels_<hash>.so`` at the root of the
checkout, keyed by a hash of every file in ``csrc/``; the library is
loaded with ctypes. Nothing is built from outside the checkout
and nothing is built at import: the first kernel launch builds.

Every C entry point that launches takes pointers and the stream as
``void*`` and returns ``cudaGetLastError()`` (or the launch's own error)
after its launches; ``check`` raises on a non-zero code. The others
return a constant of the kernels (``tsar_ransac_cluster``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from tsar_mvs_tpu_torch import trace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "tsar_mvs_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "tsar_svol_ncc_multiview": [
        _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
        ctypes.POINTER(_P), ctypes.POINTER(_I), ctypes.POINTER(_F), _I,
        _P, _I, _I, _F, _I, _I, _I, _I, _F, _F, _P, _P, _P, _P],
    "tsar_warp_build": [_P, _I, _I, _P, _F, _F, _I, _P, _P],
    "tsar_direct_multiview": [
        _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I,
        ctypes.POINTER(_P), ctypes.POINTER(_F), ctypes.POINTER(_F),
        ctypes.POINTER(_I), _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P, _I,
        _P, _P, _P, _P],
    "tsar_direct_instances": [ctypes.POINTER(_I), _I],
    "tsar_wmf_median": [_P, _P, _P, _P, _I, _I, ctypes.POINTER(_I),
                        ctypes.POINTER(_F), _I, _F, _P, _P, _P, _P, _P, _P,
                        _P],
    "tsar_ransac_regions": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                            _F, _F, _F, _P, _I, _P, _I, _I, _P, _P, _P, _P,
                            _P, _P, _P],
    "tsar_ransac_cluster": [],
    "tsar_halfpass_prop_select": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                                  ctypes.POINTER(_I), ctypes.POINTER(_I),
                                  _I, _P, _P, _P, _P, _P, _P, _P],
    "tsar_halfpass_prop_accept": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _P, _P, _P, _P, _P, _P, _I, _P, _P],
    "tsar_halfpass_refine_propose": [_P, _P, _I, _I, _I, _I, _I, _P, _P,
                                     _P, _P, _P, _F, _F, _F, _F, _F, _F,
                                     _P, _P, _P, _P, _P, _P],
    "tsar_halfpass_refine_accept": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _P, _P, _P, _P, _P, _P],
    "tsar_weak_edges": [_P, _P],
    "tsar_weak_label": [_P, _I, _P],
    "tsar_weak_hough": [_P, _P],
    "tsar_weak_regions": [_P, _P],
}

_lib: ctypes.CDLL | None = None
BUILD_LOG = ""
# Seconds from the start of the build to the end of each source's nvcc
# (they run together) and of the link; empty when this process did not
# build.
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (on PATH or under /usr/local/cuda)")


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libtsar_kernels_{source_hash()}.so"


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library: the
    `library_load` span, with a `library_load.build` child when nvcc
    runs."""
    global _lib
    if _lib is not None:
        return _lib
    with trace.span("library_load"):
        out = library_path()
        if not out.exists():
            with trace.span("library_load.build"):
                _compile(out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _compile(out: Path) -> None:
    """Every source of csrc/ through nvcc and one link into `out`."""
    global BUILD_LOG
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp, \
            contextlib.ExitStack() as open_logs:
        # One nvcc per source, all started together, then one link.
        t0 = time.perf_counter()
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            log = open_logs.enter_context(
                open(os.path.join(tmp, src.stem + ".log"), "w+"))
            jobs.append((src.name, obj, log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=log, stderr=subprocess.STDOUT)))
        running = {name for name, *_ in jobs}
        while running:
            for name, _, _, proc in jobs:
                if name in running and proc.poll() is not None:
                    BUILD_SECONDS[name] = time.perf_counter() - t0
                    running.discard(name)
            time.sleep(0.05)
        logs = []
        for _, _, log, _ in jobs:
            log.seek(0)
            logs.append(log.read())
        BUILD_LOG = "".join(logs)
        failed = [proc.returncode for *_, proc in jobs
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n"
                               f"{BUILD_LOG}")
        lib_tmp = os.path.join(tmp, out.name)
        link = subprocess.run(
            [nvcc, "-shared", "-o", lib_tmp,
             *(obj for _, obj, *_ in jobs)],
            capture_output=True, text=True)
        BUILD_SECONDS["link"] = time.perf_counter() - t0
        BUILD_LOG += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):"
                               f"\n{BUILD_LOG}")
        os.replace(lib_tmp, out)


def kernel_resources(log: str | None = None) -> list[str]:
    """One "<kernel><template arguments>: N registers, M bytes spilled"
    per compiled kernel, from ptxas's report in `log`, by default
    BUILD_LOG (empty when the library was not built in this process)."""
    out, name = [], None
    for line in (BUILD_LOG if log is None else log).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"\d+(svol_ncc\w*?_kernel|warp_build_kernel"
                          r"|direct_multiview_kernel|wmf_median_kernel"
                          r"|ransac_\w+?_kernel|halfpass_\w+?_kernel"
                          r"|weak_\w+?_kernel)"
                          r"(\w*)", m.group(1))
            name = (k.group(1) + "<" + ",".join(
                re.findall(r"L[ib](\d+)E", k.group(2))) + ">") if k \
                else m.group(1)
            spill = 0
        elif "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {spill} bytes spilled")
            name = None
    return out


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
