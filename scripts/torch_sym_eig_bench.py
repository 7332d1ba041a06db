#!/usr/bin/env python3
"""The eigensolver kernel (csrc/sym_eig.cu) across shapes, on the card,
beside an earlier design of it.

For d in {1, 2, 3, 6, 8, 16, 32}, batch in {1, 64}, f32 and f64, on
random symmetric matrices (M + M^T, M standard normal from numpy's
generator at ``--seed``):

* the kernel of this checkout against its plain version
  (``ops/sym_eig.sym_eig_plain``) and numpy's LAPACK eigh: eigenvalues and
  V diag(w) V^T within 1e-5 (f32) or 1e-12 (f64) of max|A|, times d / 8
  past d = 8 (the card tests' tolerance); any miss fails the script;
* the sweeps the kernel and the plain version took (the most over the
  batch; the kernel's under its cap), and the design's latency floor: the
  launch floor plus the plain version's sweeps times one sweep of the
  kernel timed on the same matrices (chip_smoke.sym_eig_sweep_ms);
* its ms per call (CUDA-graph replay of 20 calls), and with ``--tree DIR``
  the ms of the ``sym_eig.cu`` of the checkout at DIR (the earlier design,
  built under ``build/``, called through its own C signature with 10
  sweeps, as its wrapper called it), timed in turns (earlier, this, this,
  earlier) and checked against numpy the same way.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/torch_sym_eig_bench.py [--tree DIR] [--seed 0]

For the parent commit: ``mkdir -p build/parent && git archive HEAD | tar
-x -C build/parent`` first (the card's copy of the repository is not a git
checkout), then ``--tree build/parent``.  Prints a line a shape, one JSON
line of every shape's numbers, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

DS, BATCHES = (1, 2, 3, 6, 8, 16, 32), (1, 64)
EARLIER_SWEEPS = 10


def earlier_library(tree: Path):
    """The sym_eig.cu of the checkout at `tree`, built under build/ with
    the port's flags and loaded beside the port's own."""
    from limbo_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(_cuda.build_variant(
        tree / "limbo_tpu_torch" / "csrc" / "sym_eig.cu")))
    # (A, batch, d, sweeps, is_double, w, V, stream)
    lib.sym_eig_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p] * 3
    lib.sym_eig_launch.restype = ctypes.c_int
    return lib


def held(where: str, A: np.ndarray, w, V, tol: float) -> float:
    """Eigenvalues against numpy's and V diag(w) V^T against A within tol;
    returns the larger error, raises past tol."""
    w64, V64 = w.double().cpu().numpy(), V.double().cpu().numpy()
    ew = float(np.abs(w64 - np.linalg.eigvalsh(A)).max())
    er = float(np.abs((V64 * w64[..., None, :]) @ np.swapaxes(V64, -1, -2)
                      - A).max())
    if not (ew <= tol and er <= tol):
        raise AssertionError(f"{where}: eigenvalues {ew:.3e}, V diag(w) V^T "
                             f"{er:.3e}, tolerance {tol:.3e}")
    return max(ew, er)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=None,
                    help="a checkout whose sym_eig.cu is timed beside")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sym_eig_bench: CUDA is not available", file=sys.stderr)
        return 1
    import limbo_tpu_torch  # noqa: F401  (precision policy: TF32 off)
    import chip_smoke as cs
    from limbo_tpu_torch.ops import _cuda
    from limbo_tpu_torch.ops.sym_eig import (MAX_SWEEPS, jacobi,
                                             padded_size, sym_eig,
                                             sym_eig_plain)

    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    _cuda.build_all()
    dev = torch.device("cuda", 0)
    old = earlier_library(args.tree) if args.tree else None
    cell = torch.empty((1,), device=dev)
    floor = cs.cuda_ms(lambda: cell.fill_(1.0))
    print(f"launch floor {floor:.4f} ms", flush=True)
    rng = np.random.default_rng(args.seed)
    rows = []
    for dt in (torch.float32, torch.float64):
        for d in DS:
            for b in BATCHES:
                M = rng.standard_normal((b, d, d))
                A = M + np.swapaxes(M, -1, -2)
                At = torch.tensor(A, dtype=dt, device=dev)
                tol = ((1e-5 if dt == torch.float32 else 1e-12)
                       * float(np.abs(A).max()) * max(1, d // 8))
                where = f"{b} x {d} x {d} {str(dt)[6:]}"
                w, V = sym_eig(At)
                wp, Vp = sym_eig_plain(At)
                err = held(where, A, w, V, tol)
                dw = float((w - wp).abs().max())
                if not dw <= tol:
                    raise AssertionError(f"{where}: kernel against plain "
                                         f"{dw:.3e} over {tol:.3e}")
                sweeps = int(cs.sym_eig_sweeps(At).max())
                plain_sweeps = int(jacobi(At)[2].max())
                if sweeps >= MAX_SWEEPS:
                    raise AssertionError(f"{where}: {sweeps} sweeps, the "
                                         f"cap")
                D = padded_size(d)
                sweep_ms = cs.sym_eig_sweep_ms(At) if plain_sweeps else 0.0
                bound = floor + plain_sweeps * sweep_ms
                row = dict(dtype=str(dt)[6:], d=d, batch=b, sweeps=sweeps,
                           plain_sweeps=plain_sweeps, rounds=D - 1,
                           sweep_ms=sweep_ms, max_abs_err=err,
                           latency_floor_ms=bound)
                if old is not None:
                    wo = torch.empty_like(w)
                    Vo = torch.empty_like(V)

                    def earlier():
                        with torch.cuda.device(dev):
                            stream = torch.cuda.current_stream().cuda_stream
                        e = old.sym_eig_launch(
                            At.data_ptr(), b, d, EARLIER_SWEEPS,
                            int(dt == torch.float64), wo.data_ptr(),
                            Vo.data_ptr(), stream)
                        if e:
                            raise RuntimeError(f"earlier sym_eig: {e}")

                    earlier()
                    torch.cuda.synchronize()
                    row["earlier_err"] = held(f"{where} (earlier)", A, wo,
                                              Vo, tol)
                    t = [cs.cuda_ms(earlier), cs.cuda_ms(lambda: sym_eig(At)),
                         cs.cuda_ms(lambda: sym_eig(At)), cs.cuda_ms(earlier)]
                    row.update(earlier_ms=(t[0] + t[3]) / 2,
                               ms=(t[1] + t[2]) / 2, turns=t)
                else:
                    row["ms"] = cs.cuda_ms(lambda: sym_eig(At))
                rows.append(row)
                print(f"{where}: {row['ms']:.4f} ms"
                      + (f" (earlier design {row['earlier_ms']:.4f} ms)"
                         if old is not None else "")
                      + f"; {sweeps} sweeps (plain {plain_sweeps}) of "
                      f"{D - 1} rounds, {sweep_ms * 1e3:.4f} us a sweep, "
                      f"latency floor {bound:.4f} ms; max |err| {err:.2e} "
                      f"(tolerance {tol:.2e})", flush=True)
    if old is not None:
        slower = [f"{r['batch']} x {r['d']} x {r['d']} {r['dtype']}"
                  for r in rows if r["ms"] > r["earlier_ms"]]
        print(f"shapes slower than the earlier design: {slower or 'none'}")
    print(json.dumps({"sym_eig_shapes": rows, "launch_floor_ms": floor,
                      "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
