#!/usr/bin/env python3
"""Large-n scaling of the headline BO iteration on one H100: the port's
counterpart of scripts/large_n_bench.py, with its protocol.

Per n: the GP fit (gram_train, the Cholesky: ``cholesky_ex`` below 12288,
the blocked factor with the panel kernel from there, the solves), the
query-cache build (the tri-inv panel, K^-1, the bf16 mirror) and the BO
iteration (RandomRestarts(Rprop(20), 64 restarts, a 1024-point sweep) on
UCB (mu + 0.5 sigma) over a CachedGPView, then a deferred append).  d = 8,
capacity n + ITERS + 2 rounded up to 512, SquaredExpARD with l = 0.3 and
noise 0.09 + DataMean, y = sin(3 sum x) + 0.3 e (the reference's
well-posed large-n data), the bf16 mirror with defer_m = 32; ``--lite``
drops the f32 K^-1 (the mirror-only cache, defer_m = 256).  The fit and
the build run twice, cold and then steady, as the reference times its jit
cold and warm; of ITERS iterations the first is timed apart.  Data and
draws come from a ``torch.Generator`` seeded with SEED.

Usage, from the repository root on a machine with an NVIDIA card:

    python3 scripts/torch_large_n_bench.py [--lite] [n1 n2 ...]

(default 10240 16384 24576).  Run as a script it sets
LIMBO_TPU_FAST_MATMUL=1 unless the caller set it, as the reference's does
(utils/precision.py: TF32 where the reference leaves its default
precision, exact f32 where it pins HIGHEST); set it empty for exact mode.
Prints one JSON line per n on stdout (progress on stderr) and appends it to
scaling_results/large_n_torch.jsonl: the fit, build and iteration times in
ms, the peak GB allocated, the kernel launches of the n, the mode and the
card's name and power limit.  ``run(n, device="cpu")`` runs the same
protocol on the CPU at a small n.
"""

import os

if __name__ == "__main__":
    # before the package is imported, which reads it once
    # (scripts/large_n_bench.py:24)
    os.environ.setdefault("LIMBO_TPU_FAST_MATMUL", "1")

import json
import math
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RESTARTS, ASCENT_STEPS, SWEEP = 64, 20, 1024
ITERS = 6
D = 8
ELL, NOISE, Y_NOISE = 0.3, 0.09, 0.3
DEFER_M, LITE_DEFER_M = 32, 256
SEED = 0
DEFAULT_NS = (10240, 16384, 24576)
OUT = os.path.join("scaling_results", "large_n_torch.jsonl")


def log(msg: str) -> None:
    print(f"[torch-large-n] {msg}", file=sys.stderr, flush=True)


def capacity_for(n: int) -> int:
    return -(-(n + ITERS + 2) // 512) * 512


class Workload:
    """The bench's data, model and iteration at one n.  ``X``, ``Y`` (n, D)
    replace the generated data (the tests pass seeded numpy arrays); the
    generator draws the data, then every restart and sweep."""

    def __init__(self, n: int, lite: bool = False, device="cuda",
                 generator=None, X=None, Y=None):
        from limbo_tpu_torch.acqui import UCB
        from limbo_tpu_torch.kernels import SquaredExpARD
        from limbo_tpu_torch.means import DataMean
        from limbo_tpu_torch.models import gp as gp_mod
        from limbo_tpu_torch.opt import RandomRestarts, Rprop
        from limbo_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
        self.gp_mod, self.dev, self.lite = gp_mod, dev, lite
        self.gen = (generator if generator is not None
                    else torch.Generator(device=dev).manual_seed(SEED))
        self.capacity = capacity_for(n)
        if X is None:
            X = torch.rand((n, D), generator=self.gen, device=dev)
            Y = (torch.sin(3.0 * X.sum(dim=1, keepdim=True))
                 + Y_NOISE * torch.randn((n, 1), generator=self.gen,
                                         device=dev))
        self.X = torch.as_tensor(X, dtype=torch.float32, device=dev)
        self.Y = torch.as_tensor(Y, dtype=torch.float32, device=dev)
        kernel = SquaredExpARD.create(dim=D, noise=NOISE, device=dev)
        self.kernel = kernel.replace(
            log_ell=torch.full((D,), math.log(ELL), device=dev))
        self.mean = DataMean.create(dim_out=1, device=dev)
        self.opt = RandomRestarts(sub=Rprop(iterations=ASCENT_STEPS),
                                  repeats=RESTARTS, sweep_samples=SWEEP)
        self.acq = UCB(alpha=0.5)
        self.start = torch.full((D,), 0.5, device=dev)

    def fit(self):
        return self.gp_mod.fit(self.kernel, self.mean, self.X, self.Y,
                               capacity=self.capacity, device=self.dev)

    def build(self, gp):
        return self.gp_mod.QueryCache.build(
            gp, with_Linv=True, qdtype=torch.bfloat16,
            defer_m=LITE_DEFER_M if self.lite else DEFER_M, lite=self.lite)

    def acquire(self, gp, cache):
        """The acquisition's maximizer over the cached posterior."""
        model = self.gp_mod.CachedGPView(gp, cache)
        return self.opt(lambda Z: self.acq(model, Z), self.start, self.gen,
                        True).x

    @staticmethod
    def objective(x):
        return torch.sin(3.0 * torch.sum(x))[None]

    def append(self, gp, cache, x):
        return self.gp_mod.add_sample_cached(gp, cache, x, self.objective(x),
                                             fast_update="deferred")

    def iterate(self, gp, cache):
        return self.append(gp, cache, self.acquire(gp, cache))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def run(n: int, lite: bool = False, device="cuda", generator=None,
        iters: int = ITERS) -> tuple:
    """One n of the bench: (its record, times in ms, unrounded; the final
    GP; its cache)."""
    from limbo_tpu_torch.ops import _cuda
    from limbo_tpu_torch.utils import precision

    w = Workload(n, lite=lite, device=device, generator=generator)
    dev = w.dev
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    _cuda.reset_launches()
    gp, t_fit_cold = _timed(dev, w.fit)
    gp = None                     # free the cold fit before the steady one
    gp, t_fit = _timed(dev, w.fit)
    log(f"n={n}: fit {t_fit * 1e3:.1f} ms (cold {t_fit_cold * 1e3:.1f})")
    cache, t_build_cold = _timed(dev, lambda: w.build(gp))
    cache = None
    cache, t_build = _timed(dev, lambda: w.build(gp))
    log(f"n={n}: cache build {t_build * 1e3:.1f} ms (cold "
        f"{t_build_cold * 1e3:.1f})")
    (gp, cache), t_first = _timed(dev, lambda: w.iterate(gp, cache))

    def rest():
        g, c = gp, cache
        for _ in range(iters - 1):
            g, c = w.iterate(g, c)
        return g, c

    (gp, cache), t_rest = _timed(dev, rest)
    t_iter = t_rest / max(iters - 1, 1)
    log(f"n={n}: bo_iter {t_iter * 1e3:.2f} ms ({1 / t_iter:.2f} iters/s; "
        f"first {t_first * 1e3:.1f} ms)")
    mirror = cache.Kinv_q.float() if cache.Kinv_q is not None else cache.Kinv
    finite = bool(torch.isfinite(gp.L).all() and torch.isfinite(gp.alpha).all()
                  and torch.isfinite(mirror).all())
    del mirror
    log(f"n={n}: finite={finite}")
    rec = {"n": n, "capacity": w.capacity, "lite": lite, "finite": finite,
           "schedule": f"{RESTARTS}x{ASCENT_STEPS}", "iters": iters,
           "fast_matmul": precision.fast_mode(),
           "fit_ms": t_fit * 1e3, "fit_cold_ms": t_fit_cold * 1e3,
           "cache_build_ms": t_build * 1e3,
           "cache_build_cold_ms": t_build_cold * 1e3,
           "first_iter_ms": t_first * 1e3, "bo_iter_ms": t_iter * 1e3,
           "iters_per_s": 1 / t_iter,
           "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9 if cuda
                       else None),
           "launches": dict(_cuda.LAUNCHES),
           "n_final": gp.n, "base_n": cache.base_n}
    return rec, gp, cache


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def main(argv) -> None:
    lite = "--lite" in argv
    ns = [int(a) for a in argv if not a.startswith("--")] or list(DEFAULT_NS)
    if not torch.cuda.is_available():
        raise SystemExit("torch_large_n_bench.py: no CUDA device")
    dev_card = card()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    for n in ns:
        rec = run(n, lite=lite)[0]
        rec["card"] = dev_card
        line = json.dumps(rec)
        with open(OUT, "a") as fh:
            fh.write(line + "\n")
        print(line, flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
