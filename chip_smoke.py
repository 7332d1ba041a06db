#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (limbo_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed 0] [--iters 40]

1. Prints the card (``nvidia-smi`` name and power limit) and the versions.
2. Builds the port's CUDA kernels from ``limbo_tpu_torch/csrc`` (one nvcc
   per source, all at once) and prints the build time.
3. Kernel phase: runs each kernel against its plain PyTorch version on the
   card at the shapes of the main path, prints the largest error beside
   its stated tolerance, and times the kernel, the plain version and, where
   one PyTorch call computes the same function, that call.
4. Main path: the n = 10,000, d = 8 cached BO loop of bench.py through the
   port's entry points (fit, QueryCache.build with Linv, a bf16 mirror and
   defer_m = 32, then per iteration RandomRestarts(Rprop(20), 64 restarts,
   1024-point sweep) maximizing UCB over a CachedGPView and a deferred
   append), one warm-up iteration and ``--iters`` timed ones.  It checks
   that the state is finite, that every kernel was launched on the path,
   and the posterior: the mean against an f64 recompute from the stored
   data, the bf16 mirror product against f64, and the variance against
   its assembly from that product (``check_posterior``).
5. Prints a JSON line of the main path's numbers, a JSON line of per-kernel
   numbers, the card's name and power limit, and, last,
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result; so does a host without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

# data-sheet peaks of one H100 SXM (NVIDIA): HBM bandwidth and the f32 rate
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS = 67e12

N_POINTS, DIM, CAPACITY = 10_000, 8, 10_240
RESTARTS, STEPS, SWEEP, DEFER_M = 64, 20, 1024, 32


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Device ms per call: `reps` calls captured in one CUDA graph, so the
    replay times the card and not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    del g
    return a.elapsed_time(b) / reps


def bound_ms(nbytes: float, ops: float):
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and f32 operations over the f32 peak."""
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_close(name: str, got, want, tol, what: str) -> float:
    """Raise unless |got - want| <= tol elementwise; returns max |got-want|."""
    err = (got.double() - want.double()).abs()
    bad = int((err > tol).sum())
    mx = float(err.max())
    log(f"  {name}: max |err| {mx:.3e}, tolerance {what}: "
        f"{'ok' if bad == 0 else f'{bad} entries over'}")
    if bad:
        raise AssertionError(f"{name}: {bad} entries over tolerance")
    return mx


def kernel_phase(dev, gen):
    from limbo_tpu_torch.ops import chol, gram_pallas as gp_ops, trimv as tv

    entries = {}
    N, n, d = CAPACITY, N_POINTS, DIM
    sf2 = torch.tensor(1.3, device=dev)
    inv_l = torch.tensor(0.8, device=dev)
    dadd = torch.tensor(0.01 + 32 * 2 ** -23, device=dev)
    X2 = torch.rand((N, d), generator=gen, device=dev)
    X2[n:] = 0.0
    # gram and gram_train tiles: the reference's interpret-mode test
    # tolerance (tests/test_pallas_gram.py), |err| <= 2e-6 + 2e-5 |plain|
    log("kernel gram (csrc/gram.cu), all three forms:")
    err = 0.0
    for q in (64, SWEEP):
        X1 = torch.rand((q, d), generator=gen, device=dev)
        for form in gp_ops.FORMS:
            k = gp_ops.gram_pallas(X1, X2, sf2, inv_l, form)
            p = gp_ops.gram_plain(X1, X2, sf2, inv_l, form)
            err = max(err, check_close(f"gram {form} ({q}x{N})", k, p,
                                       2e-6 + 2e-5 * p.abs(),
                                       "2e-6 + 2e-5|plain|"))
        ms = cuda_ms(lambda: gp_ops.gram_pallas(X1, X2, sf2, inv_l, "se"))
        plain = cuda_ms(lambda: gp_ops.gram_plain(X1, X2, sf2, inv_l, "se"))
        # ops: the a.b products and norms, and ~10 per output epilogue
        b, by = bound_ms((q * d + N * d + q * N) * 4,
                         2 * d * q * N + 2 * d * (q + N) + 10 * q * N)
        log(f"  gram se ({q}x{N}x{d}): kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {b:.4f} ms ({by})")
    entries["gram"] = dict(
        route="cuda", source="limbo_tpu_torch/csrc/gram.cu",
        replaces="limbo_tpu/ops/gram_pallas.py:79", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None)

    log("kernel gram_train (csrc/gram.cu):")
    err = 0.0
    for form in gp_ops.FORMS:
        k = gp_ops.gram_train_pallas(X2, sf2, inv_l, dadd, n, form)
        p = gp_ops.gram_train_plain(X2, sf2, inv_l, dadd, n, form)
        err = max(err, check_close(f"gram_train {form} ({N}, n={n})", k, p,
                                   2e-6 + 2e-5 * p.abs(),
                                   "2e-6 + 2e-5|plain|"))
        if not torch.equal(k[n:, n:], torch.eye(N - n, device=dev)):
            raise AssertionError("gram_train padding is not the identity")
        del k, p
    ms = cuda_ms(lambda: gp_ops.gram_train_pallas(X2, sf2, inv_l, dadd, n))
    plain = cuda_ms(lambda: gp_ops.gram_train_plain(X2, sf2, inv_l, dadd, n),
                    reps=5)
    b, by = bound_ms((N * d + N * N) * 4, 2 * d * N * N + 10 * N * N)
    log(f"  gram_train se ({N}, n={n}): kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {b:.4f} ms ({by})")
    entries["gram_train"] = dict(
        route="cuda", source="limbo_tpu_torch/csrc/gram.cu",
        replaces="limbo_tpu/ops/gram_pallas.py:153", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None)

    # a real factor: L of the SE training covariance, and its inverse
    K = gp_ops.gram_train_pallas(X2 * inv_l, sf2, torch.ones((), device=dev),
                                 dadd, n, "se")
    L = chol.cholesky(K)
    del K
    if not bool(torch.isfinite(L).all()):
        raise AssertionError("kernel phase: Cholesky of the test matrix "
                             "failed")
    B = chol.TRI_INV_BLOCK
    log(f"kernel tri_inv_panel (csrc/tri_inv.cu), {N // B} blocks of {B}:")
    k = chol._tri_inv_panel(L, B)
    p = chol.tri_inv_panel_plain(L, B)
    # forward substitution in another summation order: |err| <= 1e-4 max|X|
    tol = 1e-4 * float(p.abs().max())
    err = check_close("tri_inv_panel", k, p, tol, "1e-4 max|plain|")
    nb = N // B
    ms = cuda_ms(lambda: chol._tri_inv_panel(L, B))
    plain = cuda_ms(lambda: chol.tri_inv_panel_plain(L, B), reps=3)
    D = torch.tril(chol._diag_blocks(L, B)).contiguous()
    eye = torch.eye(B, device=dev).expand(nb, B, B)
    lib = cuda_ms(lambda: torch.linalg.solve_triangular(D, eye, upper=False))
    b, by = bound_ms((nb * B * (B + 1) / 2 + nb * B * B) * 4, nb * B ** 3 / 3)
    log(f"  tri_inv_panel: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"solve_triangular {lib:.4f} ms, bound {b:.4f} ms ({by}; the "
        f"substitution chain is latency-bound)")
    entries["tri_inv_panel"] = dict(
        route="cuda", source="limbo_tpu_torch/csrc/tri_inv.cu",
        replaces="limbo_tpu/ops/chol.py:264", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib)
    del k, p, D

    Linv = chol.tri_inv_blocked(L)
    del L
    log(f"kernel trimv (csrc/trimv.cu) on a real Linv ({N}):")
    v = torch.randn((N,), generator=gen, device=dev)
    err = 0.0
    T = torch.tril(Linv)
    for tr in (False, True):
        k = tv._trimv_pallas(Linv, v, tr)
        p = tv.trimv_plain(Linv, v, tr)
        A = T.abs().T if tr else T.abs()
        # another summation order: |err| <= 1e-4 (|tril L| |v|)
        err = max(err, check_close(f"trimv transpose={tr}", k, p,
                                   1e-4 * (A @ v.abs()),
                                   "1e-4 (|tril L| |v|)"))
    del T, A
    ms = {tr: cuda_ms(lambda: tv._trimv_pallas(Linv, v, tr)) for tr in
          (False, True)}
    plain = {tr: cuda_ms(lambda: tv.trimv_plain(Linv, v, tr), reps=5)
             for tr in (False, True)}
    LinvT = Linv.T
    lib = {False: cuda_ms(lambda: torch.mv(Linv, v)),
           True: cuda_ms(lambda: torch.mv(LinvT, v))}
    b, by = bound_ms((N * (N + 1) / 2 + 2 * N) * 4, N * (N + 1))
    for tr in (False, True):
        log(f"  trimv transpose={tr}: kernel {ms[tr]:.4f} ms, plain "
            f"{plain[tr]:.4f} ms, torch.mv {lib[tr]:.4f} ms, bound "
            f"{b:.4f} ms ({by})")
    entries["trimv"] = dict(
        route="cuda", source="limbo_tpu_torch/csrc/trimv.cu",
        replaces="limbo_tpu/ops/trimv.py:87", max_abs_err=err,
        ms=(ms[False] + ms[True]) / 2,
        plain_ms=(plain[False] + plain[True]) / 2, bound_ms=b, bound_by=by, library_ms=(lib[False] + lib[True]) / 2)
    return entries


def posterior_f64(gp, Xq):
    """The exact posterior of the stored data in f64 (plain Cholesky, no
    cache, none of the port's code): mean and latent variance at Xq."""
    k = gp.kernel
    n = gp.n
    X = gp.x[:n].double()
    Y = gp.y[:n].double()
    inv_ell = torch.exp(-k.log_ell.double())
    sf2 = torch.exp(2.0 * k.log_sigma.double())
    # the f32 model's training diagonal: noise + 32 f32 eps * max(sf2, 1)
    dadd = torch.exp(2.0 * k.log_noise.double()) \
        + 32 * 2.0 ** -23 * torch.clamp(sf2, min=1.0)
    Xs, Qs = X * inv_ell, Xq.double() * inv_ell

    def r2(A, B):
        return torch.cdist(A, B,
                           compute_mode="donot_use_mm_for_euclid_dist") ** 2

    K = sf2 * torch.exp(-0.5 * r2(Xs, Xs))
    K.diagonal().add_(dadd)
    Lc = torch.linalg.cholesky(K)
    del K
    ybar = Y.mean(dim=0)
    alpha = torch.cholesky_solve(Y - ybar, Lc)
    ks = sf2 * torch.exp(-0.5 * r2(Qs, Xs))
    mu = ks @ alpha + ybar
    z = torch.linalg.solve_triangular(Lc, ks.T, upper=False)
    var = torch.clamp(sf2 - (z * z).sum(dim=0), min=0.0)
    return mu, var


class MainPath:
    """bench.py's cached BO workload through the port's entry points: the
    data from the generator, SquaredExpARD + DataMean fit at capacity
    10240, the K^-1 cache with Linv, a bf16 mirror and defer_m = 32, and
    per iteration RandomRestarts(Rprop(20), 64 restarts, 1024-point sweep)
    maximizing UCB (alpha 0.5) over a CachedGPView, then a deferred append.
    scripts/torch_iter_profile.py profiles this same workload."""

    def __init__(self, dev, gen):
        from limbo_tpu_torch.acqui import UCB
        from limbo_tpu_torch.kernels import SquaredExpARD
        from limbo_tpu_torch.means import DataMean
        from limbo_tpu_torch.models import gp as gp_mod
        from limbo_tpu_torch.opt import RandomRestarts, Rprop

        self.gp_mod, self.dev, self.gen = gp_mod, dev, gen
        n, d = N_POINTS, DIM
        self.X = torch.rand((n, d), generator=gen, device=dev)
        self.Y = (torch.sin(3.0 * self.X.sum(dim=1, keepdim=True))
                  + 0.1 * torch.randn((n, 1), generator=gen, device=dev))
        self.kernel = SquaredExpARD.create(dim=d, device=dev)
        self.mean = DataMean.create(dim_out=1, device=dev)
        self.opt = RandomRestarts(sub=Rprop(iterations=STEPS),
                                  repeats=RESTARTS, sweep_samples=SWEEP)
        self.acq = UCB(alpha=0.5)
        self.start = torch.full((d,), 0.5, device=dev)

    def fit(self):
        return self.gp_mod.fit(self.kernel, self.mean, self.X, self.Y,
                               capacity=CAPACITY, device=self.dev)

    def build(self, gp):
        return self.gp_mod.QueryCache.build(
            gp, with_Linv=True, qdtype=torch.bfloat16, defer_m=DEFER_M)

    def acquire(self, gp, cache):
        view = self.gp_mod.CachedGPView(gp, cache)
        return self.opt(lambda Z: self.acq(view, Z), self.start, self.gen,
                        True).x

    def append(self, gp, cache, x):
        y = torch.sin(3.0 * torch.sum(x))[None]
        return self.gp_mod.add_sample_cached(gp, cache, x, y,
                                             fast_update="deferred")

    def iterate(self, gp, cache):
        return self.append(gp, cache, self.acquire(gp, cache))


def check_posterior(gp, cache, Xq):
    """The cached posterior at Xq, piece by piece, each against its own
    reference and tolerance:

    * mu against the f64 posterior of the stored data, within 5e-2;
    * the bf16 mirror product t = ks @ Kinv_q (f32 sums) against the f64
      product of the same bf16 operands, within 2^-11 of sum |terms|, and
      so on |ks| @ |Kinv_q|, where nothing cancels and a product rounded
      through bf16 (up to 2^-9) misses: a control asserts that it does.
      The bound leaves room for the card's GEMM, which sums in f32 but
      truncates as it accumulates, a bias toward 0 that grows with N
      (printed as the mean signed relative error);
    * the variance against its assembly from that checked t (the deferred
      correction P P^T - diag(pending), k_diag, the clamp) within
      1e-5 + 1e-4 |v| (tests/test_gp.py::test_query_cache_bf16_mirror).

    Printed and not held: the variance's gaps to its assembly in f64 from
    the same bf16 operands, and to the f64 posterior through the mirror and
    through the f32 master.  With sum |ks_i Kinv_ij ks_j| in the 1e6
    against a variance <= 1, rounding moves it by O(1) here."""
    from limbo_tpu_torch.models import gp as gp_mod

    N = gp.capacity
    sf2 = torch.exp(2.0 * gp.kernel.log_sigma)
    with torch.no_grad():
        mu, var = gp_mod.query_cached(gp, cache, Xq)
        _, var32 = gp_mod.query_cached(gp, cache.replace(Kinv_q=None), Xq)
        ks = gp.kernel.gram(Xq, gp.x) * gp.mask[None, :]
        Kq = cache.Kinv_q
        t = gp_mod._mirror_mm(ks, Kq)
        t_abs = gp_mod._mirror_mm(ks.abs(), Kq.abs())
        t_abs_bf16 = ks.abs().to(torch.bfloat16) @ Kq.abs()
    mu64, var64 = posterior_f64(gp, Xq)
    k64, K64 = ks.to(torch.bfloat16).double(), Kq.double()
    t64 = k64 @ K64
    scale = k64.abs() @ K64.abs()
    del K64
    log("posterior at 64 points:")
    errs = dict(mu=check_close("mu vs the f64 posterior", mu[:, 0],
                               mu64[:, 0], 5e-2, "5e-2"))
    if t.dtype != torch.float32 or t_abs.dtype != torch.float32:
        raise AssertionError(f"mirror product returned {t.dtype}")
    rtol = 2.0 ** -11
    errs["mirror_product"] = check_close(
        "mirror product ks @ Kinv_q vs f64", t, t64, rtol * scale,
        "2^-11 (|ks| @ |Kinv_q|)")
    errs["mirror_product_abs"] = check_close(
        "mirror product |ks| @ |Kinv_q| vs f64", t_abs, scale,
        rtol * scale, "2^-11 relative")
    live = scale > 0                        # the padded columns are 0
    rel = (t_abs.double() - scale)[live] / scale[live]
    errs["mirror_rel_bias"] = float(rel.mean())
    log(f"  |ks| @ |Kinv_q|: signed relative error mean "
        f"{errs['mirror_rel_bias']:.3e}, max |.| {float(rel.abs().max()):.3e}"
        f" (the GEMM's f32 accumulation)")
    gap = (t_abs_bf16.double() - scale).abs()
    over = int((gap > rtol * scale).sum())
    ctl = float((gap[live] / scale[live]).max())
    log(f"  control: the same product rounded through bf16 is off by up to "
        f"{ctl:.3e} relative, {over} entries over the tolerance 2^-11")
    if not over:
        raise AssertionError("control: a bf16-rounded product passes the "
                             "mirror check")
    idx = torch.arange(N, device=ks.device)
    pend = ((idx >= cache.base_n) & (idx < gp.n)).to(ks.dtype)
    tc = t + (ks @ cache.P) @ cache.P.T - ks * pend[None, :]
    var_asm = torch.clamp(sf2 - (tc * ks).sum(dim=1), min=0.0)
    errs["var_vs_assembly"] = check_close(
        "var vs its assembly from the checked product", var, var_asm,
        1e-5 + 1e-4 * var_asm.abs(), "1e-5 + 1e-4|v|")
    ks64, P64 = ks.double(), cache.P.double()
    tc64 = t64 + (ks64 @ P64) @ P64.T - ks64 * pend.double()[None, :]
    var_e64 = torch.clamp(sf2.double() - (tc64 * ks64).sum(dim=1), min=0.0)
    errs["var_vs_f64_assembly"] = float((var.double() - var_e64).abs().max())
    errs["var_mirror_vs_f64"] = float((var.double() - var64).abs().max())
    errs["var_f32_master_vs_f64"] = float(
        (var32.double() - var64).abs().max())
    absq = float((scale * k64.abs()).sum(dim=1).max())
    log(f"  not held: var vs its assembly in f64 from the same bf16 "
        f"operands, max |err| {errs['var_vs_f64_assembly']:.3e}")
    log(f"  not held: var vs the f64 posterior, max |err| "
        f"{errs['var_mirror_vs_f64']:.3e} through the bf16 mirror, "
        f"{errs['var_f32_master_vs_f64']:.3e} through the f32 master; "
        f"max sum|ks_i Kinv_ij ks_j| {absq:.3e}")
    return errs


def main_path(dev, gen, iters: int):
    from limbo_tpu_torch.ops import _cuda

    path = MainPath(dev, gen)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    gp = path.fit()
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    cache = path.build(gp)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    gp, cache = path.iterate(gp, cache)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        gp, cache = path.iterate(gp, cache)
    torch.cuda.synchronize()
    t_iters = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    log(f"main path: fit {t_fit:.3f} s, cache build {t_build:.3f} s, "
        f"warm-up iteration {t_warm:.3f} s, {iters} iterations "
        f"{t_iters:.3f} s = {iters / t_iters:.3f} iters/s "
        f"(n {N_POINTS} -> {gp.n}, flushes at base_n {cache.base_n})")
    log(f"  launches on the main path: {launches}")

    for name, t in (("L", gp.L), ("alpha", gp.alpha), ("Linv", cache.Linv),
                    ("Kinv", cache.Kinv)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"main path: {name} is not finite")
    total = iters + 1
    want = {"gram_train": (1, None), "tri_inv_panel": (1, None),
            "gram": ((STEPS + 2) * total, None), "trimv": (2 * total,
                                                           2 * total)}
    for k, (lo, exact) in want.items():
        got = launches[k]
        if got < lo or (exact is not None and got != exact):
            raise AssertionError(f"main path: kernel {k} launched {got} "
                                 f"times, expected {'=' if exact else '>='}"
                                 f" {lo}")
    if cache.base_n == N_POINTS:
        raise AssertionError("main path: no deferred flush happened")

    errs = check_posterior(gp, cache, torch.rand((RESTARTS, DIM),
                                                 generator=gen, device=dev))
    return dict(iters_per_s=iters / t_iters, fit_s=t_fit, build_s=t_build,
                launches=launches, errs=errs, n_final=gp.n)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if args.iters < 40:
        raise SystemExit("--iters must be at least 40 (one deferred flush)")
    import limbo_tpu_torch  # noqa: F401  (precision policy: TF32 off)
    from limbo_tpu_torch.ops import _cuda

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}"
        f", {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    log(f"build: {_cuda.build_all():.1f} s for {len(_cuda.SIGNATURES)} "
        "sources")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    entries = kernel_phase(dev, gen)
    res = main_path(dev, gen, args.iters)
    kernels = [dict(name=k, route=e["route"], source=e["source"],
                    replaces=e["replaces"], launches=res["launches"][k],
                    max_abs_err=e["max_abs_err"], ms=e["ms"],
                    plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
                    bound_by=e["bound_by"], library_ms=e["library_ms"])
               for k, e in entries.items()]
    print(json.dumps({"main_path": {
        "iters_per_s": res["iters_per_s"], "fit_s": res["fit_s"],
        "build_s": res["build_s"], "posterior_err": res["errs"],
        "card": card}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
