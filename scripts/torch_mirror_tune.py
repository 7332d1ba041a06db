#!/usr/bin/env python3
"""Choose the bf16 mirror kernel's promotion interval, on the card.

Builds ``csrc/mirror_mm.cu`` once for each promotion interval in
``--intervals`` (``-DMIRROR_PROMOTION=p``: the depth each tensor-core
partial sum covers before it is added to the f32 accumulator; the shipped
build takes 64), launches each build through ``ops/mirror.mirror_mm`` and
holds it against the f64 product of its bf16 operands, with the limits of
chip_smoke.py and tests/test_torch_cuda.py:

* at the card tests' shapes (random operands, ks @ Kq and |ks| @ |Kq|): the
  largest per-entry error as a share of its limit sqrt(K) 2^-24 (|ks| @
  |Kq|), which must stay at or below 1;
* at both paths' shapes (q = 64 and 1024 against N = K = 10240 and 16896,
  the paths' covariance rounded to bf16 as the mirror, a real
  cross-covariance as ks): the same share, and the mean signed relative
  error on |ks| @ |Kq|, which must stay below 1e-6;
* the kernel's ms at the paths' shapes (CUDA-graph replay).

Prints one line per configuration and shape, then a JSON line.  Run from
the repository root on a machine with one NVIDIA H100:

    python3 scripts/torch_mirror_tune.py [--intervals 16 32 64]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# tests/test_torch_cuda.py's mirror shapes (q, K, N)
TEST_SHAPES = ((64, 2000, 2000), (37, 1000, 1003), (130, 129, 257),
               (1, 1000, 1000), (65, 1000, 1000), (64, 129, 1001))


def held(t, a, b):
    """(largest error / limit, mean signed relative error) of t against
    the f64 product of bf16(a) and b."""
    a64, b64 = a.to(torch.bfloat16).double(), b.double()
    exact = a64 @ b64
    tol = a.shape[1] ** 0.5 * 2.0 ** -24 * (a64.abs() @ b64.abs())
    ratio = float(((t.double() - exact).abs() / tol.clamp_min(1e-300)).max())
    live = exact != 0
    rel = float(((t.double() - exact)[live] / exact[live]).mean())
    return ratio, rel


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--intervals", type=int, nargs="+", default=[16, 32, 64])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mirror_tune: CUDA is not available", file=sys.stderr)
        return 1
    import limbo_tpu_torch  # noqa: F401  (precision policy: TF32 off)
    import chip_smoke as cs
    from limbo_tpu_torch.ops import _cuda, gram_pallas as gp_ops, mirror

    card = cs.card_line()
    src = _cuda.CSRC / "mirror_mm.cu"
    libs = {p: _cuda.build_variant(src, f"-DMIRROR_PROMOTION={p}")
            for p in args.intervals}
    print(f"card: {card}; built intervals {args.intervals}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {p: {} for p in args.intervals}

    def run(name, ks, Kq, Kabs, timed):
        for p, path in libs.items():
            _cuda.load("mirror_mm", path)
            r1, _ = held(mirror.mirror_mm(ks, Kq), ks, Kq)
            r2, b2 = held(mirror.mirror_mm(ks.abs(), Kabs), ks.abs(), Kabs)
            row = dict(ratio=max(r1, r2), abs_bias=b2)
            msg = ""
            if timed:
                row["ms"] = cs.cuda_ms(lambda: mirror.mirror_mm(ks, Kq))
                msg = f", kernel {row['ms']:.4f} ms"
            res[p][name] = row
            print(f"  promotion {p:3d}, {name} (tile "
                  f"{mirror._row_tile(ks.shape[0])} x {mirror._TILE_N}): "
                  f"largest error / limit {row['ratio']:.3f}, mean signed "
                  f"relative error on |ks| @ |Kq| {b2:.3e}{msg}", flush=True)

    for q, K, N in TEST_SHAPES:
        ks = torch.rand((q, K), generator=gen, device=dev) - 0.3
        Kq = torch.randn((K, N), generator=gen, device=dev).to(torch.bfloat16)
        run(f"test shape ({q}, {K}, {N})", ks, Kq, Kq.abs(), False)
    one = torch.ones((), device=dev)
    for N, n, ell, noise in ((cs.CAPACITY, cs.N_POINTS, 1.0, 0.01),
                             (cs.HP_CAPACITY, cs.HP_N, cs.HP_ELL,
                              cs.HP_NOISE)):
        X = torch.rand((N, cs.DIM), generator=gen, device=dev)
        X[n:] = 0.0
        Xs = X / ell
        dadd = torch.tensor(noise + 32 * 2 ** -23, device=dev)
        Kq = gp_ops.gram_train_pallas(Xs, one, one, dadd, n,
                                      "se").to(torch.bfloat16)
        Kabs = Kq.abs()
        for q in (64, cs.SWEEP):
            Xq = torch.rand((q, cs.DIM), generator=gen, device=dev) * Xs.max()
            ks = gp_ops.gram_pallas(Xq, Xs, one, one, "se")
            run(f"path shape ({q}, {N}, {N})", ks, Kq, Kabs, True)
        del Kq, Kabs
        torch.cuda.empty_cache()
    for key, rows in res.items():
        ok = all(v["ratio"] <= 1.0 and abs(v["abs_bias"]) < 1e-6
                 for v in rows.values())
        print(f"promotion {key}: {'passes' if ok else 'fails'} every check")
    print(json.dumps({"mirror_tune": res, "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
