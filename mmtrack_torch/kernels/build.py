"""Build and bind the hand-written Hopper kernels of `mmtrack_torch/csrc`.

Each `.cu` source is compiled with `nvcc -gencode arch=compute_90a,code=sm_90a
-O3 -c`, all of them at once in parallel processes, and the objects are
linked into one shared library with a plain C interface, loaded with
ctypes. The library is built at first use into `mmtrack_torch/kernels/_build/`
(ignored by git) under a name that hashes the sources and flags, so an
edited source is rebuilt and a stale library is never loaded. No
`--use_fast_math`: the crop geometry relies on correctly rounded `sqrtf`,
division and `ceilf`.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# No -lcuda: the GEMM looks cuTensorMapEncodeTiled up at run time
# (cudaGetDriverEntryPointByVersion in csrc/gemm.cu).
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes; every function returns a cudaError_t as int
_SIGNATURES = {
    "mmt_layernorm_bf16": (_P, _P, _P, _P, _I, _I, _F, _P),
    "mmt_gemm_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "mmt_attention_bf16": (_P, _P, _I, _I, _I, _F, _P),
    "mmt_crop_resize_normalize": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I,
                                  _P),
    "mmt_depthwise_xcorr": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "mmt_stamp": (_P, _I, _P),
}


class KernelCompileError(RuntimeError):
    pass


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelCompileError("nvcc not found: the kernels need the CUDA toolkit")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmmtrack_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library if it is not built yet.

    Returns (path, seconds spent compiling and linking; 0.0 when it was
    already built). The nvcc output of every source (with the `-Xptxas -v`
    register and spill report) is kept beside the library as `<name>.log`.
    """
    lib = _library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        t0 = time.perf_counter()
        jobs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-c", "-o", obj, str(src)]
            jobs.append((src.name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for name, _, proc in jobs:
            out = proc.communicate()[0]
            log.append(f"== {name} (exit {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if not failed:
            tmp = os.path.join(work, lib.name)
            link = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp,
                                   *(obj for _, obj, _ in jobs)],
                                  capture_output=True, text=True)
            log.append(f"== link (exit {link.returncode})\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append("link")
        seconds = time.perf_counter() - t0
        text = "\n".join(log)
        lib.with_suffix(".log").write_text(text)
        if failed:
            raise KernelCompileError(f"nvcc failed for {failed}:\n{text[-4000:]}")
        os.replace(tmp, lib)
    return lib, seconds


def sass_by_kernel(lib: Path) -> dict[str, str]:
    """The SASS of every kernel in the built library (`cuobjdump -sass`,
    from the toolkit beside nvcc), by mangled name."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            kernels[name] = ""
        elif name is not None:
            kernels[name] += line + "\n"
    return kernels


class _Kernels:
    """The loaded library: one ctypes function per kernel launcher."""

    def __init__(self, path: Path, build_seconds: float):
        self.path = path
        self.build_seconds = build_seconds
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int

    def launch(self, name: str, *args) -> None:
        """Call a launcher and raise if CUDA refused the launch."""
        err = getattr(self._lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")


_LOADED: _Kernels | None = None


def load_library() -> _Kernels:
    """Build (at first use) and load the kernel library; raises on failure."""
    global _LOADED
    if _LOADED is None:
        path, seconds = build()
        _LOADED = _Kernels(path, seconds)
    return _LOADED


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on `device`, as the int ctypes passes."""
    return torch.cuda.current_stream(device).cuda_stream
