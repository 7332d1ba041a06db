#!/usr/bin/env python3
"""Where the panel-factor kernel's time goes, on the card.

Copies ``limbo_tpu_torch/csrc/panel_factor.cu`` into ``build/`` with
``clock64()`` stamps patched in at its phase boundaries (load, diagonal
factor, diagonal inverse, panel GEMMs, assembly of the inverse, store),
builds that copy, and runs it ``--reps`` times on a real SPD block (the
first diagonal block of chip_smoke.py's hp-path covariance: squared
exponential, length scale 0.3, noise 0.09).  Prints the median cycles of
each phase and of the two chains (factor: the diagonal factors and the
panel GEMMs; inverse: the diagonal inverses and the assembly), their
shares, and the shipped kernel's ms per call from a CUDA-graph replay, with
the card's SM clock and power limit.  The shipped source has no stamps:
each patch is anchored on a line of it, and the script stops if one is
missing.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/torch_panel_split.py [--reps 50]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ("load", "diag factor", "diag inverse", "panel GEMMs",
          "X assembly", "store")
CHAINS = {"factor chain": ("diag factor", "panel GEMMs"),
          "inverse chain": ("diag inverse", "X assembly")}

STAMPS = """
constexpr int PHASES = 6;
__device__ long long g_cycles[PHASES];
#define CLOCK_START long long cyc_[PHASES] = {}, prev_ = clock64();
#define CLOCK_MARK(p) { const long long now_ = clock64(); \\
                        cyc_[p] += now_ - prev_; prev_ = now_; }
#define CLOCK_END \\
  if (t == 0) for (int i_ = 0; i_ < PHASES; ++i_) g_cycles[i_] = cyc_[i_];
"""

EXPORT = """
int panel_factor_cycles(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles));
}
"""

# (anchor, replacement): each anchor must occur once in the source; thread
# 0 (in warp 0) sums the cycles since the last stamp into phase p
PATCHES = (
    ("#include <cuda_runtime.h>\n", "#include <cuda_runtime.h>\n" + STAMPS),
    ("  const int lane = t & 31, warp = t >> 5;\n",
     "  const int lane = t & 31, warp = t >> 5;\n  CLOCK_START\n"),
    ("  for (int j0 = 0; j0 < B; j0 += W) {\n",
     "  CLOCK_MARK(0)\n  for (int j0 = 0; j0 < B; j0 += W) {\n"),
    ("      factor_diag(S, pivcol, dinv, j0, lane);\n",
     "      factor_diag(S, pivcol, dinv, j0, lane);\n      CLOCK_MARK(1)\n"),
    ("      invert_diag(S, dinv, X, j0, lane);\n",
     "      invert_diag(S, dinv, X, j0, lane);\n      CLOCK_MARK(2)\n"),
    ("    }\n  }\n\n  // off-diagonal blocks of X",
     "    }\n    CLOCK_MARK(3)\n  }\n\n  // off-diagonal blocks of X"),
    ("  // Lt = L11^T", "  CLOCK_MARK(4)\n  // Lt = L11^T"),
    ("  }\n}\n\n}  // namespace",
     "  }\n  CLOCK_MARK(5)\n  CLOCK_END\n}\n\n}  // namespace"),
    ('\n}  // extern "C"', EXPORT + '\n}  // extern "C"'),
)


def stamped_library() -> ctypes.CDLL:
    """The shipped source with the stamps patched in, built into build/."""
    from limbo_tpu_torch.ops import _cuda

    src = (_cuda.CSRC / "panel_factor.cu").read_text()
    for anchor, new in PATCHES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"torch_panel_split: anchor {anchor!r} occurs "
                               f"{src.count(anchor)} times in the source")
        src = src.replace(anchor, new)
    copy = _cuda.BUILD_DIR / "panel_split" / "panel_factor_stamped.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(src)
    lib = ctypes.CDLL(str(_cuda.build_variant(copy)))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.panel_factor_launch.argtypes = [P, I, P, P, P]
    lib.panel_factor_launch.restype = I
    lib.panel_factor_cycles.argtypes = [P]
    lib.panel_factor_cycles.restype = I
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_panel_split: CUDA is not available", file=sys.stderr)
        return 1
    import limbo_tpu_torch  # noqa: F401  (precision policy: TF32 off)
    import chip_smoke as cs
    from limbo_tpu_torch.ops import chol

    card = cs.card_line()
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    B = chol.PANEL_BLOCK
    X = torch.rand((B, cs.DIM), generator=gen, device=dev) / cs.HP_ELL
    D = torch.exp(-0.5 * torch.cdist(X, X) ** 2)
    D.diagonal().add_(cs.HP_NOISE)
    ms = cs.cuda_ms(lambda: chol._panel_factor_pallas(D))   # no stamps
    lib = stamped_library()
    lt = torch.empty((B, B), device=dev)
    v = torch.empty((B, B), device=dev)
    cycles = []
    buf = (ctypes.c_longlong * len(PHASES))()
    for _ in range(args.reps):
        err = lib.panel_factor_launch(D.data_ptr(), B, lt.data_ptr(),
                                      v.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"panel_factor_launch: CUDA error {err}")
        torch.cuda.synchronize()
        if lib.panel_factor_cycles(buf):
            raise RuntimeError("panel_factor_cycles failed")
        cycles.append(list(buf))
    Lp, _ = chol.panel_factor_plain(D)
    err = float((lt.T - Lp).abs().max())
    by = {name: statistics.median(c[i] for c in cycles)
          for i, name in enumerate(PHASES)}
    total = sum(by.values())
    chains = {k: sum(by[x] for x in v) for k, v in CHAINS.items()}
    print(f"card: {card}; SM clock max {sm_mhz:.0f} MHz")
    print(f"panel factor, ({B}, {B}) SPD block: shipped kernel {ms:.4f} ms "
          f"per call (CUDA-graph replay); stamped copy, {args.reps} "
          f"launches, max |L - plain| {err:.3e}")
    for name, c in list(by.items()) + list(chains.items()):
        print(f"  {name:14s} {c:10.0f} cycles  {c / total:6.3f}  "
              f"{c / sm_mhz:8.2f} us at {sm_mhz:.0f} MHz")
    print(json.dumps({"panel_split": dict(
        by, **chains, total_cycles=total, ms=ms, sm_mhz=sm_mhz,
        max_abs_err=err, card=card)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
