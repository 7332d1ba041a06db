"""Build, load and count the port's CUDA kernels.

Each source under ``limbo_tpu_torch/csrc/`` is compiled at first use by
``nvcc`` into its own shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), loaded with ``ctypes``, and called with
raw device pointers and PyTorch's current stream.  Libraries go into
``build/limbo_tpu_torch/`` beside the package (listed in ``.gitignore``) under
a name keyed on a hash of the source and the flags, so an edit rebuilds.
``build_all`` compiles every missing library at once, one ``nvcc`` process
per source.

Every wrapper adds one to ``LAUNCHES[<kernel>]`` where it launches its
kernel and nowhere else, so a run can show which kernels its path used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "limbo_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of every exported launcher: all return cudaGetLastError()
SIGNATURES = {
    "gram": {
        "gram_launch": [_P, _P, _I, _I, _I, _P, _P, _I, _P, _P],
        "gram_train_launch": [_P, _I, _I, _P, _P, _P, _I, _I, _P, _P],
    },
    "trimv": {"trimv_launch": [_P, _P, _I, _I, _P, _P]},
    "tri_inv": {"tri_inv_panel_launch": [_P, _I, _P, _P]},
    "panel_factor": {"panel_factor_launch": [_P, _I, _P, _P, _P]},
    "mirror_mm": {"mirror_mm_launch": [_P, _P, _I, _I, _I, _I, _I, _I,
                                        _P, _P, _P, _P]},
    "sym_eig": {"sym_eig_launch": [_P, _I, _I, _I, _I, _P, _P, _P]},
}

LAUNCHES = {"gram": 0, "gram_train": 0, "trimv": 0, "tri_inv_panel": 0,
            "panel_factor": 0, "mirror_mm": 0, "sym_eig": 0}

_LIBS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, from limbo_tpu_torch/csrc")


def _lib_path(source: Path, flags=()) -> Path:
    h = hashlib.sha256(source.read_bytes()
                       + " ".join([*NVCC_FLAGS, *flags]).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def _start_build(source: Path, flags=()):
    """Start one nvcc process building `source` (with extra nvcc `flags`)
    into a temporary file; returns (process, temporary path, final path)."""
    out = _lib_path(source, flags)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(source: Path, proc, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    os.replace(tmp, out)


def build_all() -> float:
    """Compile every library that is not built yet, all nvcc processes
    started together; returns the seconds it took."""
    t0 = time.perf_counter()
    todo = [CSRC / f"{n}.cu" for n in SIGNATURES]
    jobs = [(src, *_start_build(src)) for src in todo
            if not _lib_path(src).exists()]
    try:
        for job in jobs:
            _finish_build(*job)
    finally:
        for _, proc, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    return load(name, build_variant(CSRC / f"{name}.cu"))


def build_variant(source: Path, *flags: str) -> Path:
    """Build `source` with extra nvcc `flags` into BUILD_DIR, keyed on both,
    unless it is built already; returns the library's path.  The port's own
    libraries are csrc/<name>.cu with no flags; measurement scripts build
    variants (a -D switch, a copy with clock stamps)."""
    source = Path(source)
    out = _lib_path(source, flags)
    if not out.exists():
        _finish_build(source, *_start_build(source, flags))
    return out


def load(name: str, path: Path) -> ctypes.CDLL:
    """Load the library at `path` as csrc/<name>.cu's, its launchers typed
    from SIGNATURES[name]; the wrappers launch from it from then on."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.limbo_error_string.argtypes = [ctypes.c_int]
    lib.limbo_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def launch(name: str, fn: str, kernel: str, device: torch.device,
           *args) -> None:
    """Call launcher `fn` of library `name` on `device`'s current stream
    (appended as the last argument), raise on a CUDA error, and count one
    launch of `kernel`."""
    lib = library(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        msg = lib.limbo_error_string(err).decode()
        raise RuntimeError(f"{fn}: CUDA error {err} ({msg})")
    LAUNCHES[kernel] += 1


def check_cuda_f32(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous f32 tensor on one CUDA
    device (what the kernels take)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: tensors must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous tensors")
