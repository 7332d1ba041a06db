"""Native host components: hypervolume and exact / Monte Carlo EHVI, C++
through ctypes (port of limbo_tpu/native).

The counterparts of the reference's compiled static library
(src/hv/hypervol.c, src/ehvi/*.cc, built in src/wscript:55-67).  The two
sources under ``native/src`` are compiled at first use with
``g++ -O3 -std=c++17 -fPIC -shared`` into ``build/limbo_tpu_torch/`` beside
the package (listed in ``.gitignore``), under a name keyed on a hash of the
sources and the flags, so an edit rebuilds.  A failed build raises: there
is no silent fallback.  The plain versions (``_hv_numpy``,
``_filter_nondominated_numpy``, ``_ehvi2d_plain``, ``_ehvi3d_plain``,
``_ehvi_mc_numpy``) stay here as references for the tests; the EHVI ones
run the port's own ``ops.ehvi`` on the CPU in f64.

Convention: MAXIMIZATION relative to a reference point ``ref``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
SOURCES = (SRC / "hv.cc", SRC / "ehvi.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "limbo_tpu_torch"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lib = None

_D = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "lt_hypervolume": (ctypes.c_double, [_D, ctypes.c_int, ctypes.c_int, _D]),
    "lt_filter_nondominated": (ctypes.c_int, [
        _D, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]),
    "lt_ehvi2d_batch": (None, [_D, _D, ctypes.c_int, _D, ctypes.c_int, _D,
                               _D]),
    "lt_ehvi3d_batch": (None, [_D, _D, ctypes.c_int, _D, ctypes.c_int, _D,
                               _D]),
    "lt_ehvi_mc": (ctypes.c_double, [_D, _D, ctypes.c_int, _D, ctypes.c_int,
                                     _D, ctypes.c_int, ctypes.c_ulonglong]),
}


def lib_path() -> Path:
    """The library's path, keyed on the sources and the flags."""
    h = hashlib.sha256(b"".join(s.read_bytes() for s in SOURCES)
                       + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"liblimbo_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; returns its path.
    Raises RuntimeError when the compiler fails or is missing."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native build failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _lib = lib
    return lib


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(np.atleast_2d(a), dtype=np.float64)


def _cptr(a: np.ndarray):
    return a.ctypes.data_as(_D)


def _ref(ref, d: int, what: str) -> np.ndarray:
    ref = np.ascontiguousarray(ref, dtype=np.float64)
    if ref.shape != (d,):
        raise ValueError(f"{what}: ref of shape {ref.shape} for {d} "
                         "objectives")
    return ref


def hv_host(Y, ref) -> float:
    """Hypervolume (maximization) of Y (n, d) above ref (d,)."""
    Y = _f64(Y)
    n, d = Y.shape
    ref = _ref(ref, d, "hv_host")
    return float(_load().lt_hypervolume(_cptr(Y), n, d, _cptr(ref)))


def filter_nondominated_host(Y) -> np.ndarray:
    """Boolean keep-mask of the non-dominated rows of Y (maximization)."""
    Y = _f64(Y)
    n, d = Y.shape
    keep = np.zeros(n, dtype=np.int32)
    _load().lt_filter_nondominated(
        _cptr(Y), n, d, keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return keep.astype(bool)


def _ehvi_batch(fn: str, p: int, mu, sigma, front, ref) -> np.ndarray:
    mu, sigma, front = _f64(mu), _f64(sigma), _f64(front)
    ref = _ref(ref, p, fn)
    if mu.shape[1] != p or sigma.shape != mu.shape or front.shape[1] != p:
        raise ValueError(f"{fn}: expected {p} objectives, got mu "
                         f"{mu.shape}, sigma {sigma.shape} and front "
                         f"{front.shape}")
    out = np.zeros(mu.shape[0], dtype=np.float64)
    getattr(_load(), fn)(_cptr(mu), _cptr(sigma), mu.shape[0], _cptr(front),
                         front.shape[0], _cptr(ref), _cptr(out))
    return out


def ehvi2d_host(mu, sigma, front, ref) -> np.ndarray:
    """Exact 2-D EHVI (maximization) for a batch of candidates.

    mu, sigma: (n, 2); front: (k, 2) non-dominated; ref: (2,)."""
    return _ehvi_batch("lt_ehvi2d_batch", 2, mu, sigma, front, ref)


def ehvi3d_host(mu, sigma, front, ref) -> np.ndarray:
    """Exact 3-D EHVI (maximization) for a batch of candidates, the host
    cross-check of the box decomposition in ops/ehvi.ehvi_3d_max (reference
    capability: src/ehvi/ehvi_sliceupdate.cc).

    mu, sigma: (n, 3); front: (k, 3) non-dominated; ref: (3,)."""
    return _ehvi_batch("lt_ehvi3d_batch", 3, mu, sigma, front, ref)


def ehvi_mc_host(mu, sigma, front, ref, n_samples: int = 10000,
                 seed: int = 1234) -> float:
    """Monte Carlo EHVI for any number of objectives (maximization), from
    the library's own xorshift stream seeded with ``seed``."""
    mu = np.ascontiguousarray(mu, dtype=np.float64)
    sigma = np.ascontiguousarray(sigma, dtype=np.float64)
    front = _f64(front)
    d = mu.shape[0]
    ref = _ref(ref, d, "ehvi_mc_host")
    if mu.shape != (d,) or sigma.shape != (d,) or front.shape[1] != d:
        raise ValueError(f"ehvi_mc_host: mu {mu.shape}, sigma "
                         f"{sigma.shape}, front {front.shape}")
    return float(_load().lt_ehvi_mc(
        _cptr(mu), _cptr(sigma), mu.shape[0], _cptr(front), front.shape[0],
        _cptr(ref), int(n_samples), seed))


# ---------------------------------------------------------------------------
# plain references (tests)
# ---------------------------------------------------------------------------

def _filter_nondominated_numpy(Y) -> np.ndarray:
    Y = _f64(Y)
    ge = np.all(Y[None, :, :] >= Y[:, None, :], axis=-1)
    gt = np.any(Y[None, :, :] > Y[:, None, :], axis=-1)
    return ~np.any(ge & gt, axis=1)


def _ehvi_plain(fn, mu, sigma, front, ref) -> np.ndarray:
    import torch

    t = lambda a: torch.as_tensor(_f64(a))                      # noqa: E731
    with torch.no_grad():
        out = fn(t(mu), t(sigma), t(front), t(np.asarray(ref))[0])
    return out.numpy()


def _ehvi2d_plain(mu, sigma, front, ref) -> np.ndarray:
    """ehvi2d_host's plain version: ops.ehvi.ehvi_2d_max in f64."""
    from limbo_tpu_torch.ops.ehvi import ehvi_2d_max

    return _ehvi_plain(ehvi_2d_max, mu, sigma, front, ref)


def _ehvi3d_plain(mu, sigma, front, ref) -> np.ndarray:
    """ehvi3d_host's plain version: ops.ehvi.ehvi_3d_max in f64."""
    from limbo_tpu_torch.ops.ehvi import ehvi_3d_max

    return _ehvi_plain(ehvi_3d_max, mu, sigma, front, ref)


def _ehvi_mc_numpy(mu, sigma, front, ref, n_samples: int = 10000,
                   seed: int = 1234) -> float:
    """An MC EHVI over NumPy's stream (not the library's): the same
    estimator, another sample."""
    mu = np.asarray(mu, dtype=np.float64)
    sigma = np.asarray(sigma, dtype=np.float64)
    front, ref = _f64(front), np.asarray(ref, dtype=np.float64)
    rng = np.random.default_rng(seed)
    hv0 = _hv_numpy(front, ref)
    ys = mu[None, :] + sigma[None, :] * rng.normal(
        size=(n_samples, mu.shape[0]))
    acc = 0.0
    for y in ys:
        acc += max(_hv_numpy(np.vstack([front, y[None]]), ref) - hv0, 0.0)
    return acc / n_samples


def _hv_numpy(Y, ref) -> float:
    """Recursive dimension-sweep hypervolume in NumPy."""
    Y, ref = _f64(Y), np.asarray(ref, dtype=np.float64)
    Y = Y[np.all(Y > ref[None, :], axis=1)]
    if Y.shape[0] == 0:
        return 0.0
    d = Y.shape[1]
    if d == 1:
        return float(Y[:, 0].max() - ref[0])
    if d == 2:
        order = np.argsort(-Y[:, 0])
        vol, h = 0.0, ref[1]
        for p in Y[order]:
            if p[1] > h:
                vol += (p[0] - ref[0]) * (p[1] - h)
                h = p[1]
        return float(vol)
    order = np.argsort(-Y[:, d - 1])
    Ys = Y[order]
    vol = 0.0
    for i in range(Ys.shape[0]):
        hi = Ys[i, d - 1]
        lo = Ys[i + 1, d - 1] if i + 1 < Ys.shape[0] else ref[d - 1]
        if hi > lo:
            vol += _hv_numpy(Ys[: i + 1, : d - 1], ref[: d - 1]) * (hi - lo)
    return float(vol)
