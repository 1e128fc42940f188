"""Build and bind the port's CUDA C++ kernels (csrc/*.cu).

Each source is compiled by `nvcc -gencode arch=compute_90a,code=sm_90a
-O3 -shared` into a shared library with a plain C interface under
`qdiffusion_torch/_build/` (git-ignored) at its first use, and loaded
with ctypes. The library's name carries a hash of the source, so an
edited source builds anew. Nothing is built when this module is
imported: the CPU tests import every module, and a build happens only
where a wrapper is handed a CUDA tensor (or `build_all` is called).

    python -m qdiffusion_torch.ops._cuda     # build every source now

A wrapper calls a C function with tensor pointers (`data_ptr()`), the
current stream and plain ints/floats; the C function returns the launch's
cudaError_t and `check` raises when it is not 0.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
ARCH = "arch=compute_90a,code=sm_90a"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the exported functions, by source
SIGNATURES = {
    "flash_attention.cu": {
        "qdt_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                _I, _I, _I, _I, _I, _I, _P],
        "qdt_flash_epilogue": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                               _P],
    },
    "int_matmul.cu": {
        "qdt_int8_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "qdt_stream_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _P],
    },
}

_libs: dict = {}
build_seconds: dict = {}  # source -> seconds its nvcc took in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the port's "
                       "CUDA kernels are built from source at first use")


def _target(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes()
                            + ARCH.encode()).hexdigest()[:12]
    return BUILD / f"lib{Path(source).stem}_{digest}.so"


def _compile(source: str) -> Path:
    out = _target(source)
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / source)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {source}:\n{res.stderr}")
    build_seconds[source] = time.perf_counter() - t0
    (BUILD / f"{Path(source).stem}.ptxas.txt").write_text(res.stderr)
    os.replace(tmp, out)
    return out


def build_all() -> dict:
    """Compile every source at once (one nvcc each, started together);
    returns {source: seconds}, 0.0 for a library already built."""
    with concurrent.futures.ThreadPoolExecutor(len(SIGNATURES)) as pool:
        list(pool.map(_compile, SIGNATURES))
    return {src: build_seconds.get(src, 0.0) for src in SIGNATURES}


def library(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built on first use."""
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(_compile(source)))
        for name, argtypes in SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[source] = lib
    return lib


def check(err: int, what: str):
    if err:
        import torch

        name = torch.cuda.get_device_name() if torch.cuda.is_available() \
            else "no device"
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err} on {name}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


if __name__ == "__main__":
    for src, secs in build_all().items():
        print(f"{src}: built in {secs:.1f} s -> {_target(src)}")
