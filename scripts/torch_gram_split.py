#!/usr/bin/env python3
"""Where the covariance kernels' time goes (csrc/gram.cu), on the card.

For the ``gram.cu`` of the checkout at ``--tree`` (default: this one; an
earlier checkout unpacked under ``build/`` gives the earlier design's
numbers on the same card), at chip_smoke.py's shapes (the ascent's q = 64
and the sweep's q = 1024 against N, and the (N, N) training covariance with
n valid rows, at both paths' capacities; squared exponential, d = 8):

* the kernel as shipped, ms per call (CUDA-graph replay);
* a copy whose stores never happen (each store made conditional on a value
  the covariance never takes), so the time left is staging and arithmetic;
* the port's wrapper (``ops/gram_pallas.py``), which allocates its output
  at each call, before and after the variants' checks have run the plain
  versions (chip_smoke.py times it after its own checks);
* ``fill_`` of an output of the same shape: the card's write rate for
  these bytes with no arithmetic at all;
* copies with one change each (``variants``: the approximate __expf, the
  registers capped for three blocks an SM), each timed and held to the
  stated tolerance, 2e-6 + 2e-5 |plain|, in all three forms;
* a copy with ``clock64()`` stamps patched in at its phase boundaries:
  thread 0 of every computed tile adds its cycles by phase (staging, the
  dots, the covariance and the training epilogue, the store issue) to
  counters on the card.  Printed as cycles per tile and shares.  Stores
  are fire-and-forget, so the store phase counts the cycles a warp stalls
  to issue them: a full memory pipe shows there.

Two stamp sets: one for the current design (4 x 4 register micro-tiles),
one for the earlier design (one thread a column, 16 rows); the script
takes the set whose anchors all occur once in the source, and stops if
neither does.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/torch_gram_split.py [--tree DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STAMPS = """
constexpr int PHASES = 4;
__device__ unsigned long long g_cycles[PHASES + 1];
#define CLOCK_START long long cyc_[PHASES] = {}, prev_ = clock64();
#define CLOCK_MARK(p) { const long long now_ = clock64(); \\
                        cyc_[p] += now_ - prev_; prev_ = now_; }
#define CLOCK_END if (threadIdx.x == 0) { \\
  for (int i_ = 0; i_ < PHASES; ++i_) \\
    atomicAdd(&g_cycles[i_], (unsigned long long)cyc_[i_]); \\
  atomicAdd(&g_cycles[PHASES], 1ull); }
"""

EXPORT = """
int gram_cycles(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[PHASES + 1] = {};
    return (int)cudaMemcpyToSymbol(g_cycles, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles));
}
"""

PHASES = ("staging", "dots", "covariance", "store issue")
INCLUDE = ("#include <cuda_runtime.h>\n",
           "#include <cuda_runtime.h>\n" + STAMPS)
EXTERN = ('\n}  // extern "C"', EXPORT + '\n}  // extern "C"')

# (anchor, replacement) pairs; each anchor must occur once
DESIGNS = {
    "micro-tile": dict(
        stamps=(
            INCLUDE,
            ("  const int row0 = tile.row0, col0 = tile.col0;\n",
             "  const int row0 = tile.row0, col0 = tile.col0;\n"
             "  CLOCK_START\n"),
            ("                                col0 + TN > nvalid);\n",
             "                                col0 + TN > nvalid);\n"
             "  CLOCK_MARK(0)\n"),
            ("    switch (form) {\n",
             "    CLOCK_MARK(1)\n    switch (form) {\n"),
            ("    store_tile<TRAIN>(out, v, R0, C0, n, m, vec);\n",
             "    CLOCK_MARK(2)\n"
             "    store_tile<TRAIN>(out, v, R0, C0, n, m, vec);\n"),
            ("vec);\n  }\n}\n\n// A training tile wholly",
             "vec);\n    CLOCK_MARK(3)\n  }\n  CLOCK_END\n}\n\n"
             "// A training tile wholly"),
            EXTERN),
        no_store=(
            ("  if (STREAM) __stcs(reinterpret_cast<float4*>(p), q);\n"
             "  else *reinterpret_cast<float4*>(p) = q;\n",
             "  if (x + y + z + w == -1.0f) *reinterpret_cast<float4*>(p) = q;"
             "\n"),
            ("  if (STREAM) __stcs(p, x);\n  else *p = x;\n",
             "  if (x == -1.0f) *p = x;\n")),
        variants={
            # the approximate exp (ex2.approx of x log2 e) in all three forms
            "fast exp": (
                ("return expf(-0.5f * r2);", "return __expf(-0.5f * r2);"),
                ("return (1.0f + t) * expf(-t);",
                 "return (1.0f + t) * __expf(-t);"),
                ("return (1.0f + t + quad) * expf(-t);",
                 "return (1.0f + t + quad) * __expf(-t);")),
            # registers capped for three blocks an SM
            "3 blocks an SM": (
                ("constexpr int MIN_BLOCKS = 2;",
                 "constexpr int MIN_BLOCKS = 3;"),)}),
    "one column a thread": dict(
        stamps=(
            INCLUDE,
            ("  const int col = col0 + tx;\n",
             "  const int col = col0 + tx;\n  CLOCK_START\n"),
            ("    __syncthreads();\n#pragma unroll\n",
             "    __syncthreads();\n    CLOCK_MARK(0)\n#pragma unroll\n"),
            ("    __syncthreads();\n  }\n\n  if (col >= m) return;\n",
             "    __syncthreads();\n    CLOCK_MARK(1)\n  }\n\n"
             "  if (col >= m) return;\n"),
            ("    out[(size_t)row * m + col] = v;\n  }\n}\n",
             "    CLOCK_MARK(2)\n    out[(size_t)row * m + col] = v;\n"
             "    CLOCK_MARK(3)\n  }\n  CLOCK_END\n}\n"),
            EXTERN),
        no_store=(
            ("    out[(size_t)row * m + col] = v;\n",
             "    if (v == -1.0f) out[(size_t)row * m + col] = v;\n"),)),
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
        if all(src.count(a) == 1 for a, _ in d["stamps"] + d["no_store"]):
            return name
    raise RuntimeError("torch_gram_split: gram.cu matches no stamp set")


def library(src: str, tag: str, stamped: bool) -> ctypes.CDLL:
    """Build `src` as build/gram_split/gram_<tag>.cu and load it with the
    launchers typed as the port types them."""
    from limbo_tpu_torch.ops import _cuda

    copy = _cuda.BUILD_DIR / "gram_split" / f"gram_{tag}.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(src)
    lib = ctypes.CDLL(str(_cuda.build_variant(copy)))
    for fn, argtypes in _cuda.SIGNATURES["gram"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    if stamped:
        lib.gram_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.gram_cycles.restype = ctypes.c_int
    return lib


def stamped_cycles(lib, launch) -> tuple:
    """Tiles and cycles a tile by phase from one launch of a stamped copy."""
    buf = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    launch(lib, 0)
    torch.cuda.synchronize()
    lib.gram_cycles(buf, 1)
    if launch(lib, 0):
        raise RuntimeError("stamped launch failed")
    torch.cuda.synchronize()
    if lib.gram_cycles(buf, 0):
        raise RuntimeError("gram_cycles failed")
    tiles = buf[len(PHASES)]
    return tiles, {p: buf[i] / tiles for i, p in enumerate(PHASES)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gram_split: CUDA is not available", file=sys.stderr)
        return 1
    import limbo_tpu_torch  # noqa: F401  (precision policy: TF32 off)
    import chip_smoke as cs
    from limbo_tpu_torch.ops import gram_pallas as gp_ops

    src = (args.tree / "limbo_tpu_torch" / "csrc" / "gram.cu").read_text()
    design = design_of(src)
    spec = DESIGNS[design]
    libs = {"shipped": library(src, "shipped", False),
            "no stores": library(patched(src, spec["no_store"]), "nostore",
                                 False)}
    for name, patches in spec.get("variants", {}).items():
        libs[name] = library(patched(src, patches), name.replace(" ", "_"),
                             False)
    stamped = library(patched(src, spec["stamps"]), "stamped", True)
    card = cs.card_line()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    sf2 = torch.tensor(1.3, device=dev)
    inv_l = torch.tensor(0.8, device=dev)
    dadd = torch.tensor(0.01, device=dev)
    forms = list(gp_ops.FORMS)
    print(f"card: {card}; gram.cu of {args.tree} ({design} design)")
    rows = []
    for N, n in ((cs.CAPACITY, cs.N_POINTS), (cs.HP_CAPACITY, cs.HP_N)):
        X = torch.rand((N, cs.DIM), generator=gen, device=dev)
        X[n:] = 0.0
        shapes = []
        for q in (64, cs.SWEEP):
            Xq = torch.rand((q, cs.DIM), generator=gen, device=dev)
            out = torch.empty((q, N), device=dev)
            shapes.append((
                f"gram {q}x{N}", out,
                lambda lib, f, Xq=Xq, out=out: lib.gram_launch(
                    Xq.data_ptr(), X.data_ptr(), Xq.shape[0], N, cs.DIM,
                    sf2.data_ptr(), inv_l.data_ptr(), f, out.data_ptr(),
                    stream()),
                lambda form, Xq=Xq: gp_ops.gram_plain(Xq, X, sf2, inv_l,
                                                      form),
                lambda Xq=Xq: gp_ops.gram_pallas(Xq, X, sf2, inv_l, "se")))
        out = torch.empty((N, N), device=dev)
        shapes.append((
            f"gram_train {N}, n={n}", out,
            lambda lib, f, out=out: lib.gram_train_launch(
                X.data_ptr(), N, cs.DIM, sf2.data_ptr(), inv_l.data_ptr(),
                dadd.data_ptr(), n, f, out.data_ptr(), stream()),
            lambda form: gp_ops.gram_train_plain(X, sf2, inv_l, dadd, n,
                                                 form),
            lambda: gp_ops.gram_train_pallas(X, sf2, inv_l, dadd, n, "se")))
        for what, out, launch, plain, wrapper in shapes:
            if launch(libs["shipped"], 0):
                raise RuntimeError(f"{what}: launch failed")
            ms = {k: cs.cuda_ms(lambda lib=lib: launch(lib, 0))
                  for k, lib in libs.items()}
            if args.tree.resolve() == ROOT:
                ms["wrapper"] = cs.cuda_ms(wrapper)
            ms["fill_"] = cs.cuda_ms(lambda: out.fill_(1.0))
            # each variant's largest error over the stated tolerance,
            # 2e-6 + 2e-5 |plain|, across the three forms (<= 1 passes)
            over = {}
            for k in spec.get("variants", {}):
                worst = 0.0
                for f, form in enumerate(forms):
                    launch(libs[k], f)
                    ref = plain(form)
                    worst = max(worst, float(((out - ref).abs() / (
                        2e-6 + 2e-5 * ref.abs())).max()))
                    del ref
                over[k] = worst
            if "wrapper" in ms:
                # again, now that the plain versions' temporaries sit in the
                # allocator's cache, as chip_smoke.py times it
                ms["wrapper after plain"] = cs.cuda_ms(wrapper)
            tiles, cyc = stamped_cycles(stamped, launch)
            total = sum(cyc.values())
            gbps = out.numel() * 4 / (ms["shipped"] * 1e-3) / 1e9
            print(f"{what}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                           ms.items())
                  + f" ms ({gbps:.1f} GB/s shipped)" + "".join(
                      f"; {k}: error {v:.3f} of the tolerance"
                      for k, v in over.items()))
            print(f"  {tiles} stamped tiles, {total:.0f} cycles a tile: "
                  + ", ".join(f"{p} {c / total:.3f}" for p, c in cyc.items()))
            rows.append(dict(shape=what, ms=ms, gb_per_s=gbps, tiles=tiles,
                             cycles_per_tile=cyc, error_over_tol=over))
            del out
        del X
        torch.cuda.empty_cache()
    print(json.dumps({"gram_split": rows, "design": design, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
