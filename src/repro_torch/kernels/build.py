"""Build the CUDA kernels under repro_torch/csrc/ and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (one `extern "C"` launch
function per kernel, returning the launch's cudaGetLastError()). It is
compiled by `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC` into `build/kernels/<name>-<hash>.so` at the root of
the checkout, keyed by a hash of the sources and the flags, so a build
happens once per source version. `build_all()` starts one nvcc per
source, all at once. Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SOURCES = ("adc", "bin_overlap", "cluster_score", "embedding_bag",
                  "lstm", "topk")

_lock = threading.Lock()
_libs = {}          # name -> ctypes.CDLL
_build_log = {}     # name -> {"so", "seconds", "ptxas", "cached"}


def nvcc_path():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def _target(name):
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNEL_SOURCES):
    """Compile every named source that has no up-to-date library, one
    nvcc process per source, all started together. Returns the build
    log {name: {"so", "seconds", "ptxas", "cached"}}; raises RuntimeError
    with nvcc's output if any compile fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            src, so = _target(name)
            if so.exists():
                _build_log.setdefault(name, {"so": str(so), "seconds": 0.0,
                                             "ptxas": "", "cached": True})
                continue
            tmp = so.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True),
                           tmp, so, time.perf_counter())
        failed = []
        for name, (proc, tmp, so, t0) in procs.items():
            out, _ = proc.communicate()
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n"
                              f"{out}")
                continue
            os.replace(tmp, so)
            _build_log[name] = {"so": str(so), "seconds": secs,
                                "ptxas": out, "cached": False}
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
        return {n: dict(_build_log[n]) for n in names}


def library(name):
    """The loaded ctypes library for csrc/<name>.cu, built at first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_build_log[name]["so"])
        return _libs[name]


def stream_ptr(device):
    """PyTorch's current CUDA stream on `device`, as a ctypes pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(name, rc):
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
