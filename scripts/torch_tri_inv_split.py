#!/usr/bin/env python3
"""Where the tri-inv panel kernel's time goes (csrc/tri_inv.cu), on the card.

For the ``tri_inv.cu`` of the checkout at ``--tree`` (default: this one; an
earlier checkout unpacked under ``build/`` gives the earlier design's
numbers on the same card), at chip_smoke.py's two shapes (N = 10240 and
16896, B = 128: 80 and 132 diagonal blocks):

* the kernel as shipped, built from a copy under ``build/tri_inv_split/``,
  ms per call (CUDA-graph replay), and its largest error against the plain
  version (``ops/chol.py``) beside the tolerance, 1e-4 max|plain|;
* a copy with ``clock64()`` stamps patched in at its phase boundaries:
  thread 0 of every block adds its cycles by phase to counters on the card.
  Every boundary but the last follows a block barrier, so a phase's cycles
  are the block's; the last phase counts the cycles thread 0 takes to issue
  its stores.  Printed as cycles a block, shares, and microseconds at the
  card's maximum SM clock.

Two stamp sets: the current design (load, the 32 x 32 diagonal
sub-inverses, the merges of the 64 x 64 halves, the merge of the whole
block, store issue) and the earlier one, where each thread substitutes
down one column (load, substitution, store issue).  The script takes the
set whose anchors all occur once in the source, and stops if neither does.
The diagonal blocks are the Cholesky factors of random SPD blocks; the
kernel's time does not depend on their values.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/torch_tri_inv_split.py [--tree DIR]

For the parent commit: ``mkdir -p build/parent && git archive HEAD | tar
-x -C build/parent`` first (the card's copy of the repository is not a git
checkout), then ``--tree build/parent``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STAMPS = """
constexpr int PHASES_ = {phases};
__device__ unsigned long long g_cycles[PHASES_ + 1];
#define CLOCK_START long long cyc_[PHASES_] = {{}}, prev_ = clock64();
#define CLOCK_MARK(p) {{ const long long now_ = clock64(); \\
                        cyc_[p] += now_ - prev_; prev_ = now_; }}
#define CLOCK_END if (threadIdx.x == 0) {{ \\
  for (int i_ = 0; i_ < PHASES_; ++i_) \\
    atomicAdd(&g_cycles[i_], (unsigned long long)cyc_[i_]); \\
  atomicAdd(&g_cycles[PHASES_], 1ull); }}
"""

EXPORT = """
int tri_inv_cycles(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[PHASES_ + 1] = {};
    return (int)cudaMemcpyToSymbol(g_cycles, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles));
}
"""

INCLUDE = "#include <cuda_runtime.h>\n"
EXTERN = ('\n}  // extern "C"', EXPORT + '\n}  // extern "C"')

# phases and (anchor, replacement) pairs; each anchor must occur once
DESIGNS = {
    "sub-blocks and merges": dict(
        phases=("load", "diag sub-inverses", "merges of 64", "merge of 128",
                "store issue"),
        stamps=(
            ("  const float* Lb = L + (size_t)blockIdx.x * B * N"
             " + (size_t)blockIdx.x * B;\n",
             "  const float* Lb = L + (size_t)blockIdx.x * B * N"
             " + (size_t)blockIdx.x * B;\n  CLOCK_START\n"),
            ("  __syncthreads();\n\n  // 2. the four diagonal",
             "  __syncthreads();\n  CLOCK_MARK(0)\n\n"
             "  // 2. the four diagonal"),
            ("  if (warp < B / W) invert_diag(Ls, Rs, Xs, W * warp, lane);\n"
             "  __syncthreads();\n",
             "  if (warp < B / W) invert_diag(Ls, Rs, Xs, W * warp, lane);\n"
             "  __syncthreads();\n  CLOCK_MARK(1)\n"),
            ("  __syncthreads();\n  // 3b.",
             "  __syncthreads();\n  CLOCK_MARK(2)\n  // 3b."),
            ("  __syncthreads();\n\n  // 4. store",
             "  __syncthreads();\n  CLOCK_MARK(3)\n\n  // 4. store"),
            ("    __stcs(reinterpret_cast<float4*>(Ob + r * B + c), q);\n"
             "  }\n}\n",
             "    __stcs(reinterpret_cast<float4*>(Ob + r * B + c), q);\n"
             "  }\n  CLOCK_MARK(4)\n  CLOCK_END\n}\n"),
            EXTERN)),
    "one column a thread": dict(
        phases=("load", "substitution", "store issue"),
        stamps=(
            ("  const float* Lb = L + (size_t)blk * B * N + (size_t)blk * B;"
             "\n",
             "  const float* Lb = L + (size_t)blk * B * N + (size_t)blk * B;"
             "\n  CLOCK_START\n"),
            ("  for (int r = 0; r < B; ++r) Xs[r * B + c] = 0.f;\n"
             "  __syncthreads();\n",
             "  for (int r = 0; r < B; ++r) Xs[r * B + c] = 0.f;\n"
             "  __syncthreads();\n  CLOCK_MARK(0)\n"),
            ("    if (r >= c) Xs[r * B + c] = acc / Ls[r * B + r];\n  }\n"
             "  __syncthreads();\n",
             "    if (r >= c) Xs[r * B + c] = acc / Ls[r * B + r];\n  }\n"
             "  __syncthreads();\n  CLOCK_MARK(1)\n"),
            ("  for (int e = threadIdx.x; e < B * B; e += B) Ob[e] = Xs[e];\n",
             "  for (int e = threadIdx.x; e < B * B; e += B) Ob[e] = Xs[e];\n"
             "  CLOCK_MARK(2)\n  CLOCK_END\n"),
            EXTERN)),
}


def patched(src: str, patches) -> str:
    for anchor, new in patches:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor {anchor!r} occurs {src.count(anchor)}"
                               f" times")
        src = src.replace(anchor, new)
    return src


def design_of(src: str) -> str:
    for name, d in DESIGNS.items():
        if all(src.count(a) == 1 for a, _ in d["stamps"]):
            return name
    raise RuntimeError("torch_tri_inv_split: tri_inv.cu matches no stamp set")


def library(src: str, tag: str, stamped: bool) -> ctypes.CDLL:
    """Build `src` as build/.../tri_inv_split/tri_inv_<tag>.cu and load it
    with the launcher typed as the port types it."""
    from limbo_tpu_torch.ops import _cuda

    copy = _cuda.BUILD_DIR / "tri_inv_split" / f"tri_inv_{tag}.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(src)
    lib = ctypes.CDLL(str(_cuda.build_variant(copy)))
    for fn, argtypes in _cuda.SIGNATURES["tri_inv"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    if stamped:
        lib.tri_inv_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tri_inv_cycles.restype = ctypes.c_int
    return lib


def block_factors(dev, gen, N: int, B: int) -> torch.Tensor:
    """(N, N) lower-triangular, its diagonal blocks the Cholesky factors of
    random SPD blocks (well conditioned at any N)."""
    nb = N // B
    A = torch.randn((nb, B, B), generator=gen, device=dev)
    D = torch.linalg.cholesky(A @ A.transpose(1, 2) / B
                              + torch.eye(B, device=dev))
    L = torch.zeros((N, N), device=dev)
    L.view(nb, B, nb, B).diagonal(dim1=0, dim2=2).copy_(D.permute(1, 2, 0))
    return L


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_tri_inv_split: CUDA is not available", file=sys.stderr)
        return 1
    import limbo_tpu_torch  # noqa: F401  (precision policy: TF32 off)
    import chip_smoke as cs
    from limbo_tpu_torch.ops import chol

    src = (args.tree / "limbo_tpu_torch" / "csrc" / "tri_inv.cu").read_text()
    design = design_of(src)
    spec = DESIGNS[design]
    phases = spec["phases"]
    shipped = library(src, "shipped", False)
    stamped = library(
        patched(src, ((INCLUDE,
                       INCLUDE + STAMPS.format(phases=len(phases))),)
                + spec["stamps"]), "stamped", True)
    card = cs.card_line()
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    B = chol.TRI_INV_BLOCK
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    print(f"card: {card}; SM clock max {sm_mhz:.0f} MHz; tri_inv.cu of "
          f"{args.tree} ({design} design)")
    rows = []
    for N in (cs.CAPACITY, cs.HP_CAPACITY):
        L = block_factors(dev, gen, N, B)
        out = torch.empty((N // B, B, B), device=dev)

        def launch(lib):
            return lib.tri_inv_panel_launch(L.data_ptr(), N, out.data_ptr(),
                                            stream())

        if launch(shipped):
            raise RuntimeError("tri_inv_panel_launch failed")
        p = chol.tri_inv_panel_plain(L, B)
        tol = 1e-4 * float(p.abs().max())
        err = float((out - p).abs().max())
        if not err <= tol:
            raise AssertionError(f"N = {N}: max |err| {err:.3e} over "
                                 f"{tol:.3e}")
        del p
        ms = cs.cuda_ms(lambda: launch(shipped))
        buf = (ctypes.c_ulonglong * (len(phases) + 1))()
        if stamped.tri_inv_cycles(buf, 1) or launch(stamped):
            raise RuntimeError("stamped launch failed")
        torch.cuda.synchronize()
        if stamped.tri_inv_cycles(buf, 0):
            raise RuntimeError("tri_inv_cycles failed")
        blocks = buf[len(phases)]
        cyc = {ph: buf[i] / blocks for i, ph in enumerate(phases)}
        total = sum(cyc.values())
        print(f"N = {N} ({N // B} blocks): shipped {ms:.4f} ms a call; max "
              f"|err| {err:.3e} (tolerance {tol:.3e}); stamped: {blocks} "
              f"blocks, {total:.0f} cycles a block = {total / sm_mhz:.2f} "
              f"us at {sm_mhz:.0f} MHz")
        for ph, c in cyc.items():
            print(f"  {ph:18s} {c:9.0f} cycles  {c / total:6.3f}  "
                  f"{c / sm_mhz:7.2f} us")
        rows.append(dict(N=N, blocks=blocks, ms=ms, max_abs_err=err, tol=tol,
                         cycles_per_block=cyc, total_cycles=total))
        del L, out
        torch.cuda.empty_cache()
    print(json.dumps({"tri_inv_split": rows, "design": design,
                      "sm_mhz": sm_mhz, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
