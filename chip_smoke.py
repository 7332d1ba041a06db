#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (limbo_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed 0] [--iters 40]

1. Prints the card (``nvidia-smi`` name and power limit) and the versions.
2. Builds the port's CUDA kernels from ``limbo_tpu_torch/csrc`` (one nvcc
   per source, all at once) and prints the build time.
3. Kernel phase, at both paths' sizes (N = 10240 and N = 16896): runs each
   kernel against its plain PyTorch version on the card at the shapes of
   the path, prints the largest error beside its stated tolerance, and
   times the kernel, the plain version and, where one PyTorch call computes
   the same function, that call.  The covariance kernels (gram at q = 64
   and 1024, gram_train) also print each form's time, the achieved write
   rate and share of the bytes bound, and a launch floor (a one-element
   ``fill_`` replayed the same way); gram_train's padding rows must equal
   the identity's and the matrix its transpose, exactly.  The tri-inv
   panel's upper triangles must be +0.0 and two launches the same bits;
   it is timed in turns with the batched ``solve_triangular`` (library,
   kernel, kernel, library), and the whole ``tri_inv_blocked`` is printed
   beside ``solve_triangular(L, eye)`` (not a check).  At N = 16896 it
   adds the panel-factor kernel (a real SPD block, and indefinite blocks
   that must give NaN from the failed pivot on) and the whole blocked
   factorization beside ``cholesky_ex``.
4. Main path: the n = 10,000, d = 8 cached BO loop of bench.py through the
   port's entry points (fit, QueryCache.build with Linv, a bf16 mirror and
   defer_m = 32, then per iteration RandomRestarts(Rprop(20), 64 restarts,
   1024-point sweep) maximizing UCB over a CachedGPView and a deferred
   append), one warm-up iteration and ``--iters`` timed ones.  It checks
   that the state is finite, that every kernel of the path was launched,
   and the posterior (``check_posterior``): the mean against an f64
   recompute from the stored data, the exact-sum bf16 mirror product
   against the f64 product of its operands (and its bias), and the
   variance against its assembly from that product.
5. hp path (``hp_path``): scripts/large_n_bench.py's n = 16,384 data and
   kernel at capacity 16896.  The fit is a blocked Cholesky (132 panels);
   the blocked L is held to ``cholesky_ex`` and the f32 LML and its
   gradient to an independent f64 LML; KernelLFOpt(ParallelRepeater(
   Rprop(5), 2 repeats)) learns the kernel (every LML evaluation runs the
   training-covariance kernel and the blocked Cholesky, every gradient the
   pullback through the tri-inv kernel); then a recompute, the cache build
   and 34 cached BO iterations, with the launch counts and the posterior
   checked as on the main path.
6. bo path (``bo_path``): the library's own entry point,
   ``limbo_tpu_torch.bo``, on an inline Hartmann-6 objective (d = 6):
   (a) ``BOptimizer()`` at its defaults for 30 iterations, (b)
   ``BOptimizerHPOpt(dim_in=6)`` for 20 (hp-opt at 10 and 20), (c) the
   cached configuration (SquaredExpARD, a 4096-point init design at
   capacity 5120, deferred appends, a bf16 mirror, a rebuild every 20) for
   40.  Each run prints its set-up seconds and iterations/s, and must give
   best_value == max(observed), samples in [0, 1]^6, a finite GP, a
   posterior that agrees with f64 (in (a) and (b) within limits set by the
   posterior's own f32 sensitivity, which a control must miss), and the
   launches of its kernels: gram in every iteration of (a), and gram,
   gram_train, tri-inv, trimv and the mirror in (c).  Each kernel a run
   launched is then held against its plain version on the run's own state,
   at the run's shapes (d = 6, the kernel's own form) and the kernel
   phase's tolerances.
7. graph path (``graph_path``): the main path's iteration captured as CUDA
   graphs (``limbo_tpu_torch/bo/graph.BOStep``, two graphs: with and
   without the deferred flush).  The same fitted n = 10k state in two
   copies and two generators of one seed run 40 iterations (past one
   flush), eagerly through MainPath and by replay; the proposals and every
   tensor of the state (x, y, L, alpha, the mean, Linv, Kinv, Kinv_q, P,
   ay, u_ones and the device counts) must hold the same bits, and both runs
   launch gram 22, the mirror 22 and trimv 2 times an iteration (a replay
   adds its graph's counts, taken at the capture).  Then the posterior
   (``check_posterior``), and the captured and uncaptured iterations/s in
   alternated groups on the same state.
8. optimize_jit (``jit_path``), on -Hartmann6 as a torch function on the
   card: (a) ``BOptimizer()`` at its defaults for 30 iterations (the exact
   append, its finiteness flag read after each replay), (c) bo path (c)'s
   cached configuration for 40, (f) the defaults with
   ``MaxPredictedValue(ratio=0)``, which must freeze the run after its
   first iteration.  Each checks its history (live rows finite, frozen
   rows NaN, ``best`` monotone and equal to best_value, the samples the
   GP's and in the box, ``effective_iterations``) and its launches; (a)
   and (c) their posteriors as the bo path's.
9. suite path (``suite_path``): the benchmark suites through their entry
   points.  (a) ``bo_suite.run_suite`` runs each of the 7
   ``default_variants()`` on Hartmann6 (d = 6) at the suite's protocol (10
   init points, 190 iterations, f32, one replicate), every run captured
   by ``optimize_jit``; each must give a finite accuracy, a whole history
   and the launch counts of SUITE_COUNTS (gram once an iteration in the 5
   ascent variants, the eigensolver ``sym_eig`` 80 times an iteration in
   opt_cmaes, no kernel in opt_direct); each accuracy is printed beside the
   reference's median (not a check).  gram is held against its plain
   version on limbo_def's final GP, and ``sym_eig`` against its plain
   version on a CMA-ES covariance of the card (timed against it and
   against ``torch.linalg.eigh``).  (b) ``regression_suite.
   run_regression_suite`` on RobotArm d8 at n = 600 (capacity 768), both
   models, one replicate and one oracle replicate, precise: finite MSEs
   printed beside the reference's medians and the oracle's, gram_train
   launched (the f32 multi-start) and held against its plain version on
   the run's inputs.
10. lite path (``lite_path``): scripts/large_n_bench.py --lite 32768,
   not cut: n = 32,768, d = 8, capacity 33,280, the lite cache (Linv, a
   bf16 mirror built from it panel by panel, defer_m = 256, no f32 K^-1),
   6 BO iterations with deferred appends, then one append and a forced
   flush, replayed on a clone inside BOStep's flush graph (the same bits).
   It holds the peak memory of the build and of the flush (less than one
   f32 N x N above what stays resident), the launch counts (260 panels, 1
   tri-inv, 1 gram_train, 22 gram and 22 mirror an iteration, 2 trimv an
   append), the posterior against f64 after the iterations and after the
   flush (check_posterior_exact), the mirror after the flush against f64
   Linv^T Linv on row panels (with the pre-flush mirror as a control that
   must fail), and then each kernel against its plain version at
   N = 33,280, where it times each (``at_N33280`` in the kernels line).
11. modes path (``modes_path``): update_mode_bench.py's n = 10k with the
   "refined" (K kept) and True appends, 40 each on the same proposals; the
   launch counts, and 10 refined iterations captured against eager, bit
   for bit; the posteriors, pivots and K^-1 drift are printed, not held
   (at this conditioning the matvec pivots lose the f32 posterior in the
   reference too).
12. models path (``models_path``): the iterative (CG) GP at n = 32,768
   (its mean against the exact f64 posterior through the identity
   mu - mu_exact = (K^-1 k)^T r, the CG iterations and residuals), and
   through BOptimizer at 4096 init points; SPGP at m = 3277 (the NLML,
   its gradient and the query against f64) and through BOptimizer at
   m = 16; BOptimizer(max_model_points=200); MultiGP with 2 outputs at
   n = 4096 (bit for bit against independent fits) and ParallelLFOpt.
   Each kernel the subpaths launched is held against its plain version at
   their shapes.
13. mo path (``mo_path``): multi-objective and batch BO (the port's
   native hv / EHVI library is built with g++ at its first use here).
   (a) to (e) are the examples' loops at their own sizes in the
   reference's f64, which launch no kernel: ``Ehvi`` on mop2 (d = 2, 20 iterations), ``Nsbo`` on
   mop2 (10, each NSGA-II call's seconds and launches printed),
   ``Parego`` on zdt2 (d = 3, 15), ``Ehvi(q=2, gh_nodes=12)`` on mop2
   (10) and the 3-objective ``Ehvi`` on DTLZ2 (d = 3, 15).  (f)
   ``BOptimizer.optimize_batch(q=4, restarts=16, steps=30, QEI(128))`` on
   -Hartmann6 at bo path (c)'s width (SquaredExpARD, 4096 init points,
   capacity 5120, f32, 10 rounds): gram in every ascent step.  (g)
   ``Ehvi`` in f32 on mop2 at d = 6 with 4096 init points (capacity 4160),
   5 iterations: gram_train at each MultiGP refit and gram in each of the
   50 Rprop steps over the 64 seeds.  Each run prints its set-up seconds,
   iterations/s and launches, and must return a front that the port's
   mask and the native filter both find non-dominated (the two agree over
   every observation), whose hypervolume (hypervolume_2d against the
   native sweep to 1e-12) is above the init design's; (a) and (e) hold the
   last step's EHVI at its point in f64 against the native exact EHVI to
   1e-10, (d) its batch's q-EHVI between its best singleton's and their
   sum; (f) and (g) hold the best observations, a finite model, the
   posterior against f64 and each launched kernel against its plain
   version on the run's state.
14. Prints a JSON line of each path's numbers, a JSON line of per-kernel
   numbers, the card's name and power limit, and, last,
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result; so does a host without CUDA.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# data-sheet peaks of one H100 SXM (NVIDIA): HBM bandwidth, the f32 rate
# outside the tensor cores and the dense bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS = 67e12
PEAK_BF16_OPS = 989e12

N_POINTS, DIM, CAPACITY = 10_000, 8, 10_240
RESTARTS, STEPS, SWEEP, DEFER_M = 64, 20, 1024, 32
# the hp path: scripts/large_n_bench.py's well-posed large-n configuration
# (n = 16,384, d = 8, SquaredExpARD l = 0.3, noise 0.09, y noise 0.3,
# capacity ceil((n + 8) / 512) * 512), learned with BOptimizerHPOpt's
# strategy cut to Rprop(5) x 2 repeats
HP_N, HP_CAPACITY, HP_ELL, HP_NOISE, HP_Y_NOISE = 16_384, 16_896, 0.3, 0.09, 0.3
HP_STEPS, HP_REPEATS, HP_ITERS = 5, 2, 34   # 34 > DEFER_M: one flush
# the bo path: BOptimizer at the Hartmann-6 benchmark's width; (c) is the
# cached configuration, its init design large enough for every kernel's
# size switch (capacity 4096 + 40 + 1 -> 5120)
BO_DIM, BO_A_ITERS, BO_B_ITERS = 6, 30, 20
BO_C_INIT, BO_C_ITERS, BO_C_REFRESH = 4096, 40, 20
# the uncached posterior of runs (a) and (b) against f64: the limit in
# units of the posterior's move under one f32 rounding of its inputs and
# distances, between the sound runs' largest reading (3.02) and the
# smallest of a control's whose inputs move by 2^-9 (443), PERF.md
BO_SLACK = 2 ** 5
F32_U = 2.0 ** -24          # unit roundoff of f32
PANEL_PIVOTS = (0, 31, 32, 40, 127)   # failed pivots the panel check tries
# the graph path: the main path's iteration captured, against the eager
# one over GRAPH_ITERS iterations (past one flush), then its rate in
# alternated groups; optimize_jit's runs (a), (c) and the frozen (f)
GRAPH_ITERS, GRAPH_RATE_GROUPS, GRAPH_RATE_ITERS = 40, 4, 10
JIT_A_ITERS, JIT_C_ITERS, JIT_F_ITERS = 30, 40, 8
# the suite path: the BO suite's protocol (10 init points, 190 iterations,
# f32) for each of its 7 variants on Hartmann6 (d = 6, the suite's widest),
# one replicate each; then the regression suite at its widest, RobotArm d8
# at n = 600 (capacity 768), both models, one replicate and one oracle
# replicate, f32 data with precise=True
SUITE_INIT, SUITE_ITERS, SUITE_CMA_GENS = 10, 190, 80
REG_N, REG_CAPACITY = 600, 768
# slice 9.  The lite path: scripts/large_n_bench.py --lite 32768, not cut
# (n = 32,768, capacity 33,280, the hp path's kernel and data model, the
# lite cache with defer_m = 256), 6 iterations and one forced flush.  The
# modes path: update_mode_bench.py's n = 10k, 40 refined iterations and
# their proposals appended in True mode, 10 refined iterations captured.
# The models path: BOptimizer over the CG GP (b, cut from 10 iterations to
# 2: an iteration takes ~13 s, each acquisition step two CG solves of up to
# 256 iterations), over SPGP at m = 16 (d) and capped at 200 points (e).
LITE_N, LITE_CAPACITY, LITE_ITERS, LITE_DEFER_M = 32_768, 33_280, 6, 256
MODES_ITERS, MODES_GRAPH_ITERS = 40, 10
MODELS_B_ITERS, MODELS_D_ITERS, MODELS_E_ITERS = 2, 30, 30
# slice 10, the mo path: the examples' multi-objective loops at their own
# sizes (a to e), then optimize_batch at bo path (c)'s width (f) and EHVI in
# f32 at 4096 points (g), each kept to a few seconds on the card
MO_A_ITERS, MO_B_ITERS, MO_C_ITERS, MO_D_ITERS, MO_E_ITERS = 20, 10, 15, 10, 15
MO_F_INIT, MO_F_ROUNDS = 4096, 10
MO_G_INIT, MO_G_ITERS, MO_G_DIM = 4096, 5, 6
# the posterior's control in (f) and (g): at n = 4136 (SquaredExpARD, d = 6)
# inputs moved by 2^-9 moved the f64 mean by 27 of the limit's 32 units of
# its f32 move (sound 4.69; PERF.md, mo path), so the control moves them by
# 2^-8; the limit is BO_SLACK as elsewhere
MO_CONTROL_REL = 2.0 ** -8
# the launches of one 190-iteration run of each variant: the sweep's gram
# (1024 x 256 = 512^2) once an iteration where the ascent maximizes (the
# ascent's 64 x 256 and the hp-opt at capacity 256 stay under the kernels'
# size rule); CMA-ES's eigendecomposition once a generation; DIRECT none
SUITE_COUNTS = {
    "limbo_def": {"gram": SUITE_ITERS},
    "limbo_def_hpopt": {"gram": SUITE_ITERS},
    "opt_cmaes": {"sym_eig": SUITE_ITERS * SUITE_CMA_GENS},
    "opt_direct": {},
    "acq_ei": {"gram": SUITE_ITERS},
    "acq_ucb": {"gram": SUITE_ITERS},
    "acq_wide": {"gram": SUITE_ITERS},
}


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


def bound_ms(nbytes: float, ops: float, peak_ops: float = PEAK_F32_OPS):
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the peak rate of the operands' type."""
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_close(name: str, got, want, tol, what: str) -> float:
    """Raise unless |got - want| <= tol elementwise; returns max |got-want|."""
    err = (got.double() - want.double()).abs()
    bad = int((~(err <= tol)).sum())          # a NaN counts as over
    mx = float(err.max())
    log(f"  {name}: max |err| {mx:.3e}, tolerance {what}: "
        f"{'ok' if bad == 0 else f'{bad} entries over'}")
    if bad:
        raise AssertionError(f"{name}: {bad} entries over tolerance")
    return mx


def event_ms(fn, reps: int = 3) -> float:
    """Device ms per call of work too large or too stateful for a CUDA
    graph (a factorization): CUDA events around `reps` calls after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def write_rate(what: str, form_ms: dict, plain: float, bnd, nbytes: float,
               floor: float) -> dict:
    """Print a covariance kernel's times (each form), its achieved write
    rate and share of the bytes bound, and the launch floor + 2 x bound
    beside it; returns them."""
    ms = form_ms["se"]
    gbps = nbytes / (ms * 1e-3) / 1e9
    share = bnd[0] / ms
    log(f"  {what}: kernel se {ms:.4f}, matern32 {form_ms['matern32']:.4f}, "
        f"matern52 {form_ms['matern52']:.4f} ms; {gbps:.1f} GB/s, "
        f"{share:.3f} of the bound; plain {plain:.4f} ms; bound "
        f"{bnd[0]:.4f} ms ({bnd[1]}); launch floor + 2 x bound "
        f"{floor + 2 * bnd[0]:.4f} ms")
    return dict(ms=ms, plain_ms=plain, bound=bnd, form_ms=form_ms,
                gb_per_s=gbps, bytes_share=share)


def _entry(route_src: str, replaces: str, err, ms, plain, bnd, lib):
    return dict(route="cuda", source=f"limbo_tpu_torch/csrc/{route_src}",
                replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib)


def kernel_phase(dev, gen, N: int, n: int, ell: float, noise: float):
    """Every kernel against its plain version at the shapes a path gives
    it: capacity N with n valid points, the covariance of the path's
    length scale and noise.  Returns per-kernel entries."""
    from limbo_tpu_torch.ops import chol, gram_pallas as gp_ops, trimv as tv

    entries = {}
    d = DIM
    log(f"kernel phase at N = {N}, n = {n}:")
    sf2 = torch.tensor(1.3, device=dev)
    inv_l = torch.tensor(0.8, device=dev)
    X2 = torch.rand((N, d), generator=gen, device=dev)
    X2[n:] = 0.0
    cell = torch.empty((1,), device=dev)
    floor = cuda_ms(lambda: cell.fill_(1.0))
    log(f"launch floor (a one-element fill_, CUDA-graph replay): "
        f"{floor:.4f} ms")
    # gram and gram_train tiles: the reference's interpret-mode test
    # tolerance (tests/test_pallas_gram.py), |err| <= 2e-6 + 2e-5 |plain|
    log("kernel gram (csrc/gram.cu), all three forms:")
    err, rows = 0.0, {}
    for q in (64, SWEEP):
        X1 = torch.rand((q, d), generator=gen, device=dev)
        form_ms = {}
        for form in gp_ops.FORMS:
            k = gp_ops.gram_pallas(X1, X2, sf2, inv_l, form)
            p = gp_ops.gram_plain(X1, X2, sf2, inv_l, form)
            err = max(err, check_close(f"gram {form} ({q}x{N})", k, p,
                                       2e-6 + 2e-5 * p.abs(),
                                       "2e-6 + 2e-5|plain|"))
            form_ms[form] = cuda_ms(
                lambda: gp_ops.gram_pallas(X1, X2, sf2, inv_l, form))
        ms = form_ms["se"]
        plain = cuda_ms(lambda: gp_ops.gram_plain(X1, X2, sf2, inv_l, "se"))
        # ops: the a.b products and norms, and ~10 per output epilogue
        nbytes = (q * d + N * d + q * N) * 4
        b = bound_ms(nbytes, 2 * d * q * N + 2 * d * (q + N) + 10 * q * N)
        rows[q] = write_rate(f"gram ({q}x{N}x{d})", form_ms, plain, b,
                             nbytes, floor)
    entries["gram"] = _entry("gram.cu", "limbo_tpu/ops/gram_pallas.py:79",
                             err, rows[SWEEP]["ms"], rows[SWEEP]["plain_ms"],
                             rows[SWEEP]["bound"], None)
    entries["gram"].update(launch_floor_ms=floor, **{
        k: rows[SWEEP][k] for k in ("form_ms", "gb_per_s", "bytes_share")})
    entries["gram"]["at_q64"] = {k: v for k, v in rows[64].items()
                                 if k != "bound"}
    entries["gram"]["at_q64"]["bound_ms"] = rows[64]["bound"][0]

    log("kernel gram_train (csrc/gram.cu), all three forms:")
    dadd = torch.tensor(noise + 32 * 2 ** -23, device=dev)
    err, form_ms = 0.0, {}
    pad = torch.zeros((N - n, N), device=dev)
    pad[:, n:] = torch.eye(N - n, device=dev)
    for form in gp_ops.FORMS:
        k = gp_ops.gram_train_pallas(X2, sf2, inv_l, dadd, n, form)
        p = gp_ops.gram_train_plain(X2, sf2, inv_l, dadd, n, form)
        err = max(err, check_close(f"gram_train {form} ({N}, n={n})", k, p,
                                   2e-6 + 2e-5 * p.abs(),
                                   "2e-6 + 2e-5|plain|"))
        if not torch.equal(k[n:], pad):
            raise AssertionError("gram_train padding is not the identity")
        if not torch.equal(k, k.T):
            raise AssertionError("gram_train is not exactly symmetric")
        del k, p
        form_ms[form] = cuda_ms(
            lambda: gp_ops.gram_train_pallas(X2, sf2, inv_l, dadd, n, form))
    log("  padding rows exactly the identity's, k == k.T exactly: ok")
    del pad
    plain = cuda_ms(lambda: gp_ops.gram_train_plain(X2, sf2, inv_l, dadd, n),
                    reps=5)
    nbytes = (N * d + N * N) * 4
    b = bound_ms(nbytes, 2 * d * N * N + 10 * N * N)
    row = write_rate(f"gram_train ({N}, n={n})", form_ms, plain, b, nbytes,
                     floor)
    entries["gram_train"] = _entry("gram.cu",
                                   "limbo_tpu/ops/gram_pallas.py:153", err,
                                   row["ms"], plain, b, None)
    entries["gram_train"].update(launch_floor_ms=floor, **{
        k: row[k] for k in ("form_ms", "gb_per_s", "bytes_share")})

    # a real covariance of the path's kernel (sigma^2 = 1), its factor and
    # the factor's inverse
    one = torch.ones((), device=dev)
    K = gp_ops.gram_train_pallas(X2 / ell, one, one, dadd, n, "se")
    if N >= chol.BLOCKED_MIN_N:
        entries["panel_factor"] = panel_factor_rows(dev, K)
    L = chol.cholesky(K)
    entries["mirror_mm"] = mirror_rows(dev, gen, X2 / ell, K, N)
    del K
    if not bool(torch.isfinite(L).all()):
        raise AssertionError("kernel phase: Cholesky of the test matrix "
                             "failed")
    B = chol.TRI_INV_BLOCK
    log(f"kernel tri_inv_panel (csrc/tri_inv.cu), {N // B} blocks of {B}:")
    k = chol._tri_inv_panel(L, B)
    p = chol.tri_inv_panel_plain(L, B)
    # another summation order (sub-inverses and merges, another FMA
    # rounding): |err| <= 1e-4 max|X|
    tol = 1e-4 * float(p.abs().max())
    err = check_close("tri_inv_panel", k, p, tol, "1e-4 max|plain|")
    # tri_inv_blocked copies each inverse whole into X, so the upper
    # triangles must be +0.0 bit for bit; the order of the sums is fixed,
    # so a second launch must give the same bits
    upper = torch.triu(torch.ones((B, B), dtype=torch.bool, device=dev), 1)
    if bool(k[:, upper].view(torch.int32).any()):
        raise AssertionError("tri_inv_panel: an upper triangle is not 0.0")
    if not torch.equal(k.view(torch.int32),
                       chol._tri_inv_panel(L, B).view(torch.int32)):
        raise AssertionError("tri_inv_panel: two launches differ")
    log("  upper triangles +0.0 bit for bit, two launches the same bits: ok")
    nb = N // B
    D = torch.tril(chol._diag_blocks(L, B)).contiguous()
    eye = torch.eye(B, device=dev).expand(nb, B, B)

    def kern():
        return chol._tri_inv_panel(L, B)

    def library():
        return torch.linalg.solve_triangular(D, eye, upper=False)

    # in turns: library, kernel, kernel, library
    turns = [cuda_ms(f) for f in (library, kern, kern, library)]
    ms, lib = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    plain = cuda_ms(lambda: chol.tri_inv_panel_plain(L, B), reps=3)
    b = bound_ms((nb * B * (B + 1) / 2 + nb * B * B) * 4, nb * B ** 3 / 3)
    log(f"  tri_inv_panel: kernel {ms:.4f} ms ({turns[1]:.4f}, "
        f"{turns[2]:.4f}), batched solve_triangular {lib:.4f} ms "
        f"({turns[0]:.4f}, {turns[3]:.4f}; in turns: library, kernel, "
        f"kernel, library), plain {plain:.4f} ms, bound {b[0]:.4f} ms "
        f"({b[1]}; the kernel's chain of steps is latency-bound)")
    entries["tri_inv_panel"] = _entry("tri_inv.cu",
                                      "limbo_tpu/ops/chol.py:264", err, ms,
                                      plain, b, lib)
    entries["tri_inv_panel"]["turns"] = dict(library_ms=turns[0::3],
                                             ms=turns[1:3])
    del k, p, D
    # not a check: the panel's share of the blocked inverse it serves, and
    # the library's solve of the full matrix
    blocked = event_ms(lambda: chol.tri_inv_blocked(L))
    eye = torch.eye(N, device=dev)
    full = event_ms(lambda: torch.linalg.solve_triangular(L, eye,
                                                          upper=False))
    del eye
    log(f"  not a check: tri_inv_blocked ({N}) {blocked:.3f} ms, of which "
        f"the panel {ms / blocked:.4f}; solve_triangular(L, eye) {full:.3f} "
        f"ms")
    entries["tri_inv_panel"]["blocked"] = dict(tri_inv_blocked_ms=blocked,
                                               solve_triangular_ms=full)

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
    b = bound_ms((N * (N + 1) / 2 + 2 * N) * 4, N * (N + 1))
    for tr in (False, True):
        log(f"  trimv transpose={tr}: kernel {ms[tr]:.4f} ms, plain "
            f"{plain[tr]:.4f} ms, torch.mv {lib[tr]:.4f} ms, bound "
            f"{b[0]:.4f} ms ({b[1]})")
    entries["trimv"] = _entry("trimv.cu", "limbo_tpu/ops/trimv.py:87", err,
                              (ms[False] + ms[True]) / 2,
                              (plain[False] + plain[True]) / 2, b,
                              (lib[False] + lib[True]) / 2)
    del Linv, LinvT
    torch.cuda.empty_cache()
    return entries


def panel_factor_rows(dev, K):
    """The panel-factor kernel on a real SPD diagonal block of K and on an
    indefinite one, then the whole blocked factorization of K."""
    from limbo_tpu_torch.ops import chol

    B = chol.PANEL_BLOCK
    N = K.shape[0]
    log(f"kernel panel_factor (csrc/panel_factor.cu), ({B}, {B}) blocks:")
    D = K[:B, :B]                       # the first panel's block, strided
    Lk, Vk = chol._panel_factor_pallas(D)
    Lp, Vp = chol.panel_factor_plain(D)
    # two factorization orders of a block of condition < 10: within
    # 1e-4 max|plain| (~13 B 2^-24)
    err = max(check_close("panel L11", Lk, Lp, 1e-4 * float(Lp.abs().max()),
                          "1e-4 max|plain|"),
              check_close("panel L11^-T", Vk, Vp,
                          1e-4 * float(Vp.abs().max()), "1e-4 max|plain|"))
    # the kernel factors in 32-wide sub-blocks: pivots at their boundaries
    # and inside one
    for p in PANEL_PIVOTS:
        bad = D.clone()
        bad[p, p] = -1.0
        Lb, _ = chol._panel_factor_pallas(bad)
        if not (bool(torch.isnan(torch.diagonal(Lb)[p:]).all())
                and bool(torch.isfinite(Lb[:p, :p]).all())):
            raise AssertionError(f"panel_factor: an indefinite block did not "
                                 f"give NaN from its failed pivot {p} on")
    log(f"  indefinite blocks (pivot {list(PANEL_PIVOTS)} < 0): NaN from the "
        f"pivot on, finite before it: ok")
    ms = cuda_ms(lambda: chol._panel_factor_pallas(D))
    plain = cuda_ms(lambda: chol.panel_factor_plain(D))
    eye = torch.eye(B, device=dev)
    lib = cuda_ms(lambda: torch.linalg.solve_triangular(
        torch.linalg.cholesky_ex(D)[0], eye, upper=False))
    b = bound_ms(3 * B * B * 4, 2 * B ** 3 / 3)
    log(f"  panel_factor: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"cholesky_ex + solve_triangular {lib:.4f} ms, bound {b[0]:.5f} ms "
        f"({b[1]}; the {B} pivot steps are latency-bound)")
    fact = event_ms(lambda: chol.cholesky_blocked(K))
    fact_lib = event_ms(lambda: torch.linalg.cholesky_ex(K))
    fb = bound_ms(2 * N * N * 4, N ** 3 / 3)
    log(f"  blocked factorization ({N}, {N // B} panels): {fact:.3f} ms, "
        f"torch.linalg.cholesky_ex {fact_lib:.3f} ms, bound {fb[0]:.3f} ms "
        f"({fb[1]})")
    e = _entry("panel_factor.cu", "limbo_tpu/ops/chol.py:198", err, ms,
               plain, b, lib)
    e["factorization"] = dict(ms=fact, library_ms=fact_lib, bound_ms=fb[0],
                              panels=N // B)
    return e


def mirror_rows(dev, gen, Xs, K, N):
    """The exact-sum mirror kernel at the query's q = 64 and the sweep's
    q = 1024 against N: a real cross-covariance of the path's kernel times
    a real (N, N) operand of its scale (the covariance K rounded to bf16),
    held to the f64 product of the same bf16 operands within the f32
    rounding of one sum, sqrt(N) 2^-24 sum|terms|, and on |ks| @ |Kq|,
    where nothing cancels, to a mean signed relative error below 1e-6.  The
    bound is the function's: bf16 operands at the tensor-core rate."""
    from limbo_tpu_torch.ops import gram_pallas as gp_ops, mirror

    log(f"kernel mirror_mm (csrc/mirror_mm.cu), the port's own, N = {N}, "
        f"promotion interval {mirror.PROMOTION}:")
    Kq = K.to(torch.bfloat16)
    Kabs = Kq.abs()
    one = torch.ones((), device=dev)
    rows, err, bias = {}, 0.0, {}
    for q in (64, SWEEP):
        Xq = torch.rand((q, DIM), generator=gen, device=dev) * Xs.max()
        ks = gp_ops.gram_pallas(Xq, Xs, one, one, "se")
        k64 = ks.to(torch.bfloat16).double()
        for name, b in (("ks @ Kq", Kq), ("|ks| @ |Kq|", Kabs)):
            t = mirror.mirror_mm(ks.abs() if b is Kabs else ks, b)
            B64 = b.double()
            exact = (k64.abs() if b is Kabs else k64) @ B64
            scale = k64.abs() @ B64.abs()
            err = max(err, check_close(f"mirror_mm {name} ({q}x{N}) vs f64",
                                       t, exact, N ** 0.5 * F32_U * scale,
                                       "sqrt(N) 2^-24 (|ks| @ |Kq|)"))
            del B64
        live = scale > 0
        bias[q] = float(((t.double() - scale)[live] / scale[live]).mean())
        log(f"  |ks| @ |Kq| ({q}x{N}): signed relative error mean "
            f"{bias[q]:.3e} (limit 1e-6)")
        if not abs(bias[q]) < 1e-6:
            raise AssertionError("mirror_mm: biased sums")
        del t, exact, scale
        ms = cuda_ms(lambda: mirror.mirror_mm(ks, Kq))
        plain = cuda_ms(lambda: mirror.mirror_mm_plain(ks, Kq))
        lib = cuda_ms(lambda: torch.mm(ks.to(torch.bfloat16), Kq,
                                       out_dtype=torch.float32))
        b = bound_ms(N * N * 2 + 2 * q * N * 4, 2.0 * q * N * N,
                     PEAK_BF16_OPS)
        log(f"  mirror_mm ({q}x{N}x{N}): kernel {ms:.4f} ms (tile "
            f"{mirror._row_tile(q)} x {mirror._TILE_N}, promotion "
            f"{mirror.PROMOTION}), plain (f32 "
            f"upcast GEMM) {plain:.4f} ms, torch.mm(bf16, out_dtype=f32) "
            f"{lib:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
        rows[q] = (ms, plain, b, lib)
    ms, plain, b, lib = rows[64]
    e = _entry("mirror_mm.cu", "none (the port's own; the reference's "
               "product is an XLA dot, limbo_tpu/models/gp.py:496)", err,
               ms, plain, b, lib)
    e["promotion"] = mirror.PROMOTION
    e["rel_bias"] = bias[64]
    ms, plain, b, lib = rows[SWEEP]
    e["at_q1024"] = dict(ms=ms, plain_ms=plain, bound_ms=b[0],
                         bound_by=b[1], library_ms=lib, rel_bias=bias[SWEEP])
    return e


def posterior_f64(gp, Xq, rel: float = 0.0, dist: bool = False):
    """The exact posterior of the stored data in f64 (plain Cholesky, no
    cache, none of the port's code): mean and latent variance at Xq, for
    SquaredExpARD (rank 0) and MaternFiveHalves with DataMean or
    NullMean.  With ``rel`` > 0, every input (the data, the queries and
    the kernel's parameters) is first multiplied by 1 + rel e, and with
    ``dist`` every squared distance is moved by rel e (|a|^2 + |b|^2), the
    size of the terms of the expanded form |a|^2 + |b|^2 - 2 a.b the
    kernels compute (utils/maths.sq_dist); e is uniform in [-1, 1] from a
    fixed seed."""
    from limbo_tpu_torch.kernels import MaternFiveHalves, SquaredExpARD

    g = torch.Generator().manual_seed(1)

    def e_of(shape, dev):
        return (torch.rand(shape, generator=g, dtype=torch.float64) * 2
                - 1).to(dev)

    def r(t):
        t = t.double()
        return t * (1.0 + rel * e_of(t.shape, t.device)) if rel else t

    k = gp.kernel
    n = gp.n
    X = r(gp.x[:n])
    Y = r(gp.y[:n])
    sf2 = r(torch.exp(2.0 * k.log_sigma.double()))
    # the f32 model's training diagonal: noise + 32 f32 eps * max(sf2, 1)
    dadd = r(torch.exp(2.0 * k.log_noise.double())) \
        + 32 * 2.0 ** -23 * torch.clamp(sf2, min=1.0)

    def sq(A, B, sym):
        # in place where a temporary would be N x N (the same operations
        # in the same order): at n = 32k each f64 N x N is 8.6 GB
        d2 = torch.cdist(A, B, compute_mode="donot_use_mm_for_euclid_dist")
        d2.mul_(d2)
        if not (rel and dist):
            return d2
        e = e_of(d2.shape, d2.device)
        if sym:
            e = e + e.T
            e.div_(2)
        terms = (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :]
        d2.add_(e.mul_(rel).mul_(terms))
        del e, terms
        return d2.clamp_(min=0.0)

    if isinstance(k, SquaredExpARD) and k.A.shape[1] == 0:
        inv_ell = 1.0 / r(torch.exp(k.log_ell.double()))

        def cov(A, B, sym=False):
            return sq(A * inv_ell, B * inv_ell, sym).mul_(-0.5).exp_() \
                .mul_(sf2)
    elif isinstance(k, MaternFiveHalves):
        ell = r(torch.exp(k.log_l.double()))

        def cov(A, B, sym=False):
            t = math.sqrt(5.0) * torch.sqrt(sq(A, B, sym)) / ell
            return sf2 * (1.0 + t + t * t / 3.0) * torch.exp(-t)
    else:
        raise TypeError(f"posterior_f64: {type(k).__name__}")
    Qs = r(Xq)
    K = cov(X, X, sym=True)
    K.diagonal().add_(dadd)
    Lc = torch.linalg.cholesky(K)
    del K
    from limbo_tpu_torch.means import NullMean

    # DataMean's mean of the data; a MultiGP's outputs carry a NullMean
    ybar = 0.0 if isinstance(gp.mean, NullMean) else Y.mean(dim=0)
    alpha = torch.cholesky_solve(Y - ybar, Lc)
    ks = cov(Qs, X)
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
    scripts/torch_iter_profile.py profiles this same workload.  The hp path
    runs the same loop on large_n_bench.py's data and kernel (n, capacity,
    length scale, noise and the data's noise as arguments)."""

    def __init__(self, dev, gen, n=N_POINTS, capacity=CAPACITY, ell=1.0,
                 noise=0.01, y_noise=0.1):
        from limbo_tpu_torch.acqui import UCB
        from limbo_tpu_torch.kernels import SquaredExpARD
        from limbo_tpu_torch.means import DataMean
        from limbo_tpu_torch.models import gp as gp_mod
        from limbo_tpu_torch.opt import RandomRestarts, Rprop

        self.gp_mod, self.dev, self.gen = gp_mod, dev, gen
        self.capacity = capacity
        d = DIM
        self.X = torch.rand((n, d), generator=gen, device=dev)
        self.Y = (torch.sin(3.0 * self.X.sum(dim=1, keepdim=True))
                  + y_noise * torch.randn((n, 1), generator=gen, device=dev))
        self.kernel = SquaredExpARD.create(dim=d, noise=noise, device=dev)
        self.kernel = self.kernel.replace(
            log_ell=torch.full((d,), math.log(ell), device=dev))
        self.mean = DataMean.create(dim_out=1, device=dev)
        self.opt = RandomRestarts(sub=Rprop(iterations=STEPS),
                                  repeats=RESTARTS, sweep_samples=SWEEP)
        self.acq = UCB(alpha=0.5)
        self.start = torch.full((d,), 0.5, device=dev)
        self.fast_update = "deferred"

    def fit(self):
        return self.gp_mod.fit(self.kernel, self.mean, self.X, self.Y,
                               capacity=self.capacity, device=self.dev)

    def build(self, gp):
        return self.gp_mod.QueryCache.build(
            gp, with_Linv=True, qdtype=torch.bfloat16, defer_m=DEFER_M)

    def propose(self, model, gen):
        """The acquisition's maximizer over a model (a CachedGPView)."""
        return self.opt(lambda Z: self.acq(model, Z), self.start, gen,
                        True).x

    def acquire(self, gp, cache, gen=None):
        return self.propose(self.gp_mod.CachedGPView(gp, cache),
                            gen if gen is not None else self.gen)

    @staticmethod
    def objective(x):
        return torch.sin(3.0 * torch.sum(x))[None]

    def append(self, gp, cache, x):
        return self.gp_mod.add_sample_cached(gp, cache, x, self.objective(x),
                                             fast_update=self.fast_update)

    def iterate(self, gp, cache, gen=None):
        return self.append(gp, cache, self.acquire(gp, cache, gen))


def check_posterior(gp, cache, Xq):
    """The cached posterior at Xq, piece by piece, each against its own
    reference and tolerance:

    * mu against the f64 posterior of the stored data, within 5e-2;
    * the bf16 mirror product t = ks @ Kinv_q (the exact-sum kernel) against
      the f64 product of the same bf16 operands, within the f32 rounding of
      one sum, sqrt(N) 2^-24 sum|terms|, and so on |ks| @ |Kinv_q|, where
      nothing cancels, with a mean signed relative error below 1e-6 (no
      bias).  A control asserts that a product rounded through bf16 (up to
      2^-9) misses the bound;
    * the variance against its assembly from that t (the deferred
      correction P P^T - diag(pending), k_diag, the clamp) within
      1e-5 + 1e-4 |v| (tests/test_gp.py::test_query_cache_bf16_mirror);
    * the variance against its assembly in f64 from the exact product of
      the same bf16 operands, within 1e-5 + 1e-4 |v| plus the f32 rounding
      of the products and of the quadratic form, sqrt(N) 2^-24 sum_j
      |ks_j| (|ks| @ |Kinv_q|)_j.  Held only where that limit stays below
      the prior variance; at n = 10k, where sum |ks_i Kinv_ij ks_j| is in
      the 1e6, it is wider than the variance's range, so it is printed and
      not held.

    Printed and not held: the gaps to the exact f64 posterior through the
    mirror and through the f32 master, and how far the cuBLAS f32 GEMM of
    the upcast operands and the tensor-core bf16 GEMM land from the exact
    product (the library's rounding, for comparison)."""
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
        kb = ks.to(torch.bfloat16)
        t_sgemm = kb.float() @ Kq.float()
        t_tc = torch.mm(kb, Kq, out_dtype=torch.float32)
        t_abs_bf16 = ks.abs().to(torch.bfloat16) @ Kq.abs()
    mu64, var64 = posterior_f64(gp, Xq)
    k64, K64 = kb.double(), Kq.double()
    t64 = k64 @ K64
    scale = k64.abs() @ K64.abs()
    del K64
    log(f"posterior at {Xq.shape[0]} points (n = {gp.n}, N = {N}):")
    errs = dict(mu=check_close("mu vs the f64 posterior", mu[:, 0],
                               mu64[:, 0], 5e-2, "5e-2"))
    if t.dtype != torch.float32 or t_abs.dtype != torch.float32:
        raise AssertionError(f"mirror product returned {t.dtype}")
    ptol = N ** 0.5 * F32_U * scale
    errs["mirror_product"] = check_close(
        "mirror product ks @ Kinv_q vs f64", t, t64, ptol,
        "sqrt(N) 2^-24 (|ks| @ |Kinv_q|)")
    errs["mirror_product_abs"] = check_close(
        "mirror product |ks| @ |Kinv_q| vs f64", t_abs, scale, ptol,
        "sqrt(N) 2^-24 relative")
    live = scale > 0                        # the padded columns are 0
    rel = (t_abs.double() - scale)[live] / scale[live]
    errs["mirror_rel_bias"] = float(rel.mean())
    log(f"  |ks| @ |Kinv_q|: signed relative error mean "
        f"{errs['mirror_rel_bias']:.3e} (limit 1e-6), max |.| "
        f"{float(rel.abs().max()):.3e}")
    if not abs(errs["mirror_rel_bias"]) < 1e-6:
        raise AssertionError("mirror product: biased sums")
    for name, tt in (("cuBLAS f32 GEMM of the upcast operands", t_sgemm),
                     ("tensor-core bf16 GEMM, out_dtype=f32", t_tc)):
        e = (tt.double() - t64).abs()
        log(f"  not held: {name}: max |err| {float(e.max()):.3e}, "
            f"{float((e / ptol.clamp_min(1e-300)).max()):.3f} of the limit")
    gap = (t_abs_bf16.double() - scale).abs()
    over = int((gap > ptol).sum())
    ctl = float((gap[live] / scale[live]).max())
    log(f"  control: the same product rounded through bf16 is off by up to "
        f"{ctl:.3e} relative, {over} entries over the limit")
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
    absq = (scale * k64.abs()).sum(dim=1)
    vtol = 1e-5 + 1e-4 * var_e64.abs() + N ** 0.5 * F32_U * absq
    vlim = float(vtol.max())
    if vlim < float(sf2):
        errs["var_vs_exact_assembly"] = check_close(
            "var vs its f64 assembly from the exact product", var, var_e64,
            vtol, f"1e-5 + 1e-4|v| + sqrt(N) 2^-24 sum|terms| (<= {vlim:.3e})")
    else:
        errs["var_vs_exact_assembly"] = float(
            (var.double() - var_e64).abs().max())
        log(f"  not held: var vs its f64 assembly from the exact product, "
            f"max |err| {errs['var_vs_exact_assembly']:.3e}; the f32 "
            f"rounding limit {vlim:.3e} exceeds the prior variance")
    errs["var_mirror_vs_f64"] = float((var.double() - var64).abs().max())
    errs["var_f32_master_vs_f64"] = float(
        (var32.double() - var64).abs().max())
    log(f"  not held: var vs the f64 posterior, max |err| "
        f"{errs['var_mirror_vs_f64']:.3e} through the bf16 mirror, "
        f"{errs['var_f32_master_vs_f64']:.3e} through the f32 master; "
        f"max sum|ks_i Kinv_ij ks_j| {float(absq.max()):.3e}")
    return errs


class uncounted:
    """Launches made to check a result against its reference are not the
    path's: the launch counts are restored on exit."""

    def __enter__(self):
        from limbo_tpu_torch.ops import _cuda

        self.counts = _cuda.LAUNCHES
        self.saved = dict(self.counts)

    def __exit__(self, *exc):
        self.counts.update(self.saved)


def check_counts(where: str, launches: dict, want: dict) -> None:
    """want: kernel -> (least count, exact count or None)."""
    for k, (lo, exact) in want.items():
        got = launches[k]
        if got < lo or (exact is not None and got != exact):
            raise AssertionError(f"{where}: kernel {k} launched {got} times, "
                                 f"expected {'=' if exact else '>='} {lo}")


def check_finite(where: str, **tensors) -> None:
    for name, t in tensors.items():
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{where}: {name} is not finite")


def bo_iterations(path, gp, cache, iters: int):
    """`iters` cached BO iterations; returns (gp, cache, seconds, seconds
    of the first iteration)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_first = None
    for _ in range(iters):
        gp, cache = path.iterate(gp, cache)
        if t_first is None:
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
    torch.cuda.synchronize()
    return gp, cache, time.perf_counter() - t0, t_first


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
    gp, cache, t_warm, _ = bo_iterations(path, gp, cache, 1)
    gp, cache, t_iters, _ = bo_iterations(path, gp, cache, iters)
    launches = dict(_cuda.LAUNCHES)
    log(f"main path: fit {t_fit:.3f} s, cache build {t_build:.3f} s, "
        f"warm-up iteration {t_warm:.3f} s, {iters} iterations "
        f"{t_iters:.3f} s = {iters / t_iters:.3f} iters/s "
        f"(n {N_POINTS} -> {gp.n}, flushes at base_n {cache.base_n})")
    log(f"  launches on the main path: {launches}")

    check_finite("main path", L=gp.L, alpha=gp.alpha, Linv=cache.Linv,
                 Kinv=cache.Kinv)
    total = iters + 1
    check_counts("main path", launches, {
        "gram_train": (1, None), "tri_inv_panel": (1, None),
        "gram": ((STEPS + 2) * total, None), "trimv": (2 * total, 2 * total),
        "mirror_mm": ((STEPS + 2) * total, None)})
    if cache.base_n == N_POINTS:
        raise AssertionError("main path: no deferred flush happened")
    with uncounted():
        errs = check_posterior(gp, cache, torch.rand(
            (RESTARTS, DIM), generator=gen, device=dev))
    return dict(iters_per_s=iters / t_iters, fit_s=t_fit, build_s=t_build,
                launches=launches, errs=errs, n_final=gp.n)


def lml_f64(X, Y, theta, noise: float):
    """The LML of SquaredExpARD (theta = [log l (d), log sigma]) + DataMean
    with the f32 model's training diagonal, in f64 and with none of the
    port's code: torch.cdist, inline exp and noise, torch.linalg.cholesky.
    Returns (LML, its data-fit part -a/2, its -logdet/2 part)."""
    d = X.shape[1]
    Xs = X * torch.exp(-theta[:d])
    sf2 = torch.exp(2.0 * theta[d])
    r2 = torch.cdist(Xs, Xs, compute_mode="donot_use_mm_for_euclid_dist") ** 2
    K = sf2 * torch.exp(-0.5 * r2)
    del r2
    K.diagonal().add_(noise + 32 * 2.0 ** -23 * torch.clamp(sf2, min=1.0))
    Lc = torch.linalg.cholesky(K)
    del K
    c = Y - Y.mean(dim=0)
    fit = -0.5 * torch.sum(c * torch.cholesky_solve(c, Lc))
    logdet = -torch.sum(torch.log(torch.diagonal(Lc)))
    n = X.shape[0]
    return fit + logdet - 0.5 * n * math.log(2.0 * math.pi), fit, logdet


def check_blocked_factor(L, K):
    """The blocked factor L of K (f32, on the card), entry by entry:

    * backward: |L L^T - K| <= N 2^-24 (|L| |L|^T), the componentwise
      backward error of a Cholesky factorization in f32 (gamma_{N+1};
      Higham, Accuracy and Stability of Numerical Algorithms, Thm 10.3),
      with the residual formed in f64.  The limit scales with the entries
      it compares, so it holds the small far-off-diagonal ones too;
    * forward: |L - L_ex| <= 1e-4 max|L_ex| against torch.linalg.cholesky_ex
      of the same K, the panel row's rule for two f32 factorization orders.
      It holds the large entries.

    Two controls must miss: L with a far block column's GEMM skipped (the
    update from every earlier panel left out) misses the backward limit,
    and L rounded through bf16 misses both.  Returns the errors."""
    from limbo_tpu_torch.ops import chol

    N = K.shape[0]
    gam = N * F32_U
    L64, K64 = L.double(), K.double()
    A = L64.abs()
    btol = gam * (A @ A.T)
    del A
    out = dict(LLt_minus_K=check_close(
        "blocked L L^T vs K (f64 residual)", L64 @ L64.T, K64, btol,
        "N 2^-24 (|L| |L|^T)"))
    del btol
    torch.cuda.empty_cache()
    Lx = torch.linalg.cholesky_ex(K)[0]
    ftol = 1e-4 * float(Lx.abs().max())
    out["L_vs_cholesky_ex"] = check_close(
        "blocked L vs cholesky_ex", L, Lx, ftol, "1e-4 max|L_ex|")

    # control 1: block column J computed from K_IJ alone, its GEMM over the
    # earlier panels skipped; only the rows below J change
    B = chol.PANEL_BLOCK
    j0 = (N // B // 2) * B
    J, I = slice(j0, j0 + B), slice(j0 + B, N)
    miss = L64[I, :j0] @ L64[J, :j0].T
    Lbad = L64[I].clone()
    Lbad[:, J] += torch.linalg.solve_triangular(L64[J, J].T, miss,
                                                upper=True, left=False)
    res = (Lbad @ L64[J].T - K64[I, J]).abs()
    over_gemm = int((res > gam * (Lbad.abs() @ L64[J].abs().T)).sum())
    del miss, Lbad, res
    # control 2: L rounded through bf16 (the residual's diagonal suffices)
    Lb = L.to(torch.bfloat16).double()
    sq = (Lb * Lb).sum(dim=1)
    over_diag = int(((sq - torch.diagonal(K64)).abs() > gam * sq).sum())
    over_fwd = int(((Lb - Lx.double()).abs() > ftol).sum())
    log(f"  controls: a skipped GEMM at block column {j0 // B} puts "
        f"{over_gemm} entries over the backward limit; L rounded to bf16 "
        f"{over_diag} diagonal residuals and {over_fwd} entries over the "
        f"forward limit")
    if not (over_gemm and over_diag and over_fwd):
        raise AssertionError("control: a wrong factor passes the blocked-L "
                             "checks")
    return out


def check_hp_start(gp, X, Y):
    """Before the hp step: the blocked L against K and against
    torch.linalg.cholesky_ex of the same K (check_blocked_factor), and the
    port's f32 LML and gradient at the initial
    parameters against the independent f64 LML (lml_f64).  Returns the
    errors and the seconds of one f32 LML + gradient evaluation."""
    from limbo_tpu_torch.models import gp as gp_mod

    N = gp.capacity
    K = gp.kernel.gram_train_masked(gp.x, gp.n)
    out = check_blocked_factor(gp.L, K)
    del K
    torch.cuda.empty_cache()

    p = gp.kernel.params.clone().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = gp_mod.log_marginal_likelihood(gp.kernel.with_params(p), gp.mean,
                                       gp.x, gp.y, gp.n)
    (g,) = torch.autograd.grad(v, p)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    v = v.detach()
    torch.cuda.empty_cache()

    theta = p.detach().double().requires_grad_(True)
    n = gp.n
    v64, fit64, ld64 = lml_f64(X[:n].double(), Y[:n].double(), theta,
                               float(gp.kernel.noise))
    g_fit, = torch.autograd.grad(fit64, theta, retain_graph=True)
    g_ld, = torch.autograd.grad(ld64, theta, retain_graph=True)
    g64, = torch.autograd.grad(v64, theta)
    const = 0.5 * n * math.log(2.0 * math.pi)
    # the rounding of a sum of N terms in f32: N 2^-24 sum|terms|, for the
    # value (its three parts) and for each gradient entry (its two parts)
    vtol = N * F32_U * (abs(float(fit64.detach())) + abs(float(ld64.detach()))
                        + const)
    out["lml"] = check_close("f32 LML vs the independent f64 LML", v,
                             v64.detach(),
                             vtol, f"N 2^-24 sum|parts| = {vtol:.3e}")
    out["lml_grad"] = check_close(
        "f32 LML gradient vs f64", g, g64,
        N * F32_U * (g_fit.abs() + g_ld.abs()),
        "N 2^-24 (|d fit| + |d logdet|)")
    log(f"  LML f32 {float(v):.6f}, f64 {float(v64.detach()):.6f}; gradient f32 "
        f"{[round(x, 4) for x in g.tolist()]}")
    del theta, v64, fit64, ld64
    torch.cuda.empty_cache()
    return out, t_eval


def hp_path(dev, gen, iters: int):
    """Slice 2: fit at n = 16,384 (the blocked Cholesky: 132 panels), learn
    the kernel's hyperparameters with BOptimizerHPOpt's strategy cut to
    KernelLFOpt(ParallelRepeater(Rprop(5), 2 repeats)), recompute, build
    the cache (Linv, bf16 mirror, defer_m = 32) and run `iters` cached BO
    iterations."""
    from limbo_tpu_torch.bo import default_hp_opt
    from limbo_tpu_torch.models import gp as gp_mod
    from limbo_tpu_torch.ops import _cuda

    path = MainPath(dev, gen, n=HP_N, capacity=HP_CAPACITY, ell=HP_ELL,
                    noise=HP_NOISE, y_noise=HP_Y_NOISE)
    strategy = default_hp_opt(iterations=HP_STEPS, repeats=HP_REPEATS)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    gp = path.fit()
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    with uncounted():
        errs, t_eval = check_hp_start(gp, path.X, path.Y)
    lml0 = float(gp_mod.log_lik(gp))
    p0 = gp.kernel.params
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gp = strategy(gp, gen)
    torch.cuda.synchronize()
    t_hp = time.perf_counter() - t0
    t0 = time.perf_counter()
    gp = gp_mod.recompute(gp)
    torch.cuda.synchronize()
    t_re = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    lml1 = float(gp_mod.log_lik(gp))
    t0 = time.perf_counter()
    cache = path.build(gp)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    gp, cache, t_iters, t_first = bo_iterations(path, gp, cache, iters)
    launches = dict(_cuda.LAUNCHES)
    evals = HP_REPEATS * (HP_STEPS + 1)      # each step + the final point
    backwards = HP_REPEATS * HP_STEPS
    log(f"hp path: fit {t_fit:.3f} s (n {HP_N}, capacity {HP_CAPACITY}); "
        f"one f32 LML + gradient {t_eval:.3f} s; hp-opt {t_hp:.3f} s "
        f"({evals} LML evaluations, {backwards} gradients); recompute "
        f"{t_re:.3f} s; cache build {t_build:.3f} s; {iters} iterations "
        f"{t_iters:.3f} s = {iters / t_iters:.3f} iters/s (first "
        f"{t_first:.3f} s); peak device memory of hp-opt + recompute "
        f"{peak / 1e9:.3f} GB")
    log(f"  parameters {[round(x, 4) for x in p0.tolist()]} -> "
        f"{[round(x, 4) for x in gp.kernel.params.tolist()]}; LML "
        f"{lml0:.4f} -> {lml1:.4f}")
    log(f"  launches on the hp path: {launches}")
    if not lml1 >= lml0:
        raise AssertionError("hp path: the LML fell during hp-opt")
    check_finite("hp path", L=gp.L, alpha=gp.alpha, Linv=cache.Linv,
                 Kinv_q=cache.Kinv_q.float())
    panels = HP_CAPACITY // 128
    factorizations = 1 + evals + 2           # fit, evaluations, 2 refits
    check_counts("hp path", launches, {
        "panel_factor": (panels * factorizations, None),
        "tri_inv_panel": (1 + backwards, None),
        "gram_train": (evals, None),
        "gram": ((STEPS + 2) * iters, None), "trimv": (2 * iters, 2 * iters),
        "mirror_mm": ((STEPS + 2) * iters, None)})
    if cache.base_n == HP_N:
        raise AssertionError("hp path: no deferred flush happened")
    with uncounted():
        errs.update(check_posterior(gp, cache, torch.rand(
            (RESTARTS, DIM), generator=gen, device=dev)))
    return dict(iters_per_s=iters / t_iters, fit_s=t_fit, eval_s=t_eval,
                hp_s=t_hp, recompute_s=t_re, build_s=t_build,
                first_iter_s=t_first, peak_gb=peak / 1e9, lml=[lml0, lml1],
                launches=launches, errs=errs, n_final=gp.n)


def hartmann6(x):
    """The objective of the bo path: -Hartmann6 (limbo's bench function,
    limbo_tpu/benchmarks/functions.py:70-91, maximized: 3.32237 at its
    optimum), from a (6,) numpy array to a (1,) one, in f64 on the host."""
    x = torch.as_tensor(x, dtype=torch.float64)
    s = torch.sum(_H6_A * (x[None, :] - _H6_P) ** 2, dim=1)
    return torch.sum(_H_ALPHA * torch.exp(-s)).reshape(1).numpy()


_H_ALPHA = torch.tensor([1.0, 1.2, 3.0, 3.2], dtype=torch.float64)
_H6_A = torch.tensor([[10., 3., 17., 3.5, 1.7, 8.],
                      [0.05, 10., 17., 0.1, 8., 14.],
                      [3., 3.5, 1.7, 10., 17., 8.],
                      [17., 8., 0.05, 10., 0.1, 14.]], dtype=torch.float64)
_H6_P = torch.tensor([[0.1312, 0.1696, 0.5569, 0.0124, 0.8283, 0.5886],
                      [0.2329, 0.4135, 0.8307, 0.3736, 0.1004, 0.9991],
                      [0.2348, 0.1451, 0.3522, 0.2883, 0.3047, 0.6650],
                      [0.4047, 0.8828, 0.8732, 0.5743, 0.1091, 0.0381]],
                     dtype=torch.float64)


class _Recorded:
    """The objective, recording every point it is asked for and every value
    it returns (an account kept apart from the GP's buffers): ``ys`` the
    first objective's, ``obs`` every objective's."""

    def __init__(self, f):
        self.f, self.xs, self.ys, self.obs = f, [], [], []

    def __call__(self, x):
        y = self.f(x)
        self.xs.append(x.copy())
        self.ys.append(float(y[0]))
        self.obs.append(y)
        return y


class _SetupClock:
    """A stop criterion that never stops: at its first call, the end of the
    run's set-up (init design evaluated and appended, cache built), it
    waits on the card and notes the time."""

    def __init__(self):
        self.t = None

    def __call__(self, state) -> bool:
        if self.t is None:
            torch.cuda.synchronize()
            self.t = time.perf_counter()
        return False


def check_posterior_exact(gp, Xq, control_rel: float = 2.0 ** -9):
    """The uncached posterior at Xq against the f64 posterior of the stored
    data (posterior_f64).  The limits follow the posterior's own
    conditioning: BO_SLACK times how far the f64 posterior moves when every
    input, and the terms of every squared distance, move by up to one f32
    rounding (2^-24 relative), for mu and for the variance.  A control
    asserts that both limits can fail: the posterior from inputs moved by up
    to ``control_rel`` (one bf16 rounding, 2^-9, unless the caller's state
    needs a larger move to leave the limits) must miss each of them."""
    from limbo_tpu_torch.models import gp as gp_mod

    with torch.no_grad():
        mu, var = gp_mod.query(gp, Xq)
    mu64, var64 = posterior_f64(gp, Xq)
    mu_s, var_s = posterior_f64(gp, Xq, rel=F32_U, dist=True)
    mu_c, var_c = posterior_f64(gp, Xq, rel=control_rel)
    sens = dict(mu=float((mu_s - mu64).abs().max()),
                var=float((var_s - var64).abs().max()))
    tol = {k: BO_SLACK * v for k, v in sens.items()}
    log(f"posterior at {Xq.shape[0]} points (n = {gp.n}, N = "
        f"{gp.capacity}, {type(gp.kernel).__name__}); its move under one "
        f"f32 rounding (2^-24): mu {sens['mu']:.3e}, var {sens['var']:.3e}:")
    errs = dict(mu=check_close("mu vs the f64 posterior", mu[:, 0],
                               mu64[:, 0], tol["mu"],
                               f"{BO_SLACK} x that ({tol['mu']:.3e})"),
                var=check_close("var vs the f64 posterior", var, var64,
                                tol["var"],
                                f"{BO_SLACK} x that ({tol['var']:.3e})"))
    errs.update(sens_mu=sens["mu"], sens_var=sens["var"],
                control_mu=float((mu_c - mu64).abs().max()),
                control_var=float((var_c - var64).abs().max()))
    log(f"  in units of that move: mu {errs['mu'] / sens['mu']:.3g}, var "
        f"{errs['var'] / sens['var']:.3g}; control (inputs moved by "
        f"2^{math.log2(control_rel):.0f}): mu "
        f"{errs['control_mu']:.3e} ({errs['control_mu'] / sens['mu']:.3g}),"
        f" var {errs['control_var']:.3e} "
        f"({errs['control_var'] / sens['var']:.3g})")
    if not (errs["control_mu"] > tol["mu"]
            and errs["control_var"] > tol["var"]):
        raise AssertionError(f"control: a posterior from inputs moved by "
                             f"{control_rel} passes the posterior check")
    return errs


def bo_kernel_checks(where: str, gp, cache, gen, dev) -> float:
    """The kernels a bo run launched, each held against its plain version
    on the run's own state at the kernel phase's tolerances: gram (the
    kernel's own form and input scaling, d = 6) at the ascent's q = 64 and
    the sweep's q = 1024 against the stored x wherever the run takes the
    kernel there (n m >= 512^2); with a cache, gram_train of the stored x at
    its n, the tri-inv panel of the stored factor, and trimv on the cache's
    Linv times a cross-covariance column of the run.  The mirror product is
    check_posterior's.  Returns the largest error."""
    from limbo_tpu_torch.kernels.base import effective_jitter
    from limbo_tpu_torch.ops import chol, gram_pallas as gp_ops, trimv as tv

    k = gp.kernel
    N, n, d = gp.capacity, gp.n, gp.x.shape[1]
    form, X2, sf2, inv_l = k._fused_train_args(gp.x)
    log(f"{where}: its kernels on the run's state (N = {N}, n = {n}, "
        f"d = {d}, {form}):")
    err = 0.0
    for q in (RESTARTS, SWEEP):
        X1 = k._fused_train_args(
            torch.rand((q, d), generator=gen, device=dev))[1]
        if not gp_ops.use_pallas(X1, X2):
            continue
        kk = gp_ops.gram_pallas(X1, X2, sf2, inv_l, form)
        p = gp_ops.gram_plain(X1, X2, sf2, inv_l, form)
        err = max(err, check_close(f"gram {form} ({q}x{N}x{d})", kk, p,
                                   2e-6 + 2e-5 * p.abs(),
                                   "2e-6 + 2e-5|plain|"))
    if cache is None:
        return err
    dadd = k.noise + effective_jitter(torch.float32) * torch.clamp(sf2,
                                                                   min=1.0)
    kk = gp_ops.gram_train_pallas(X2, sf2, inv_l, dadd, n, form)
    p = gp_ops.gram_train_plain(X2, sf2, inv_l, dadd, n, form)
    err = max(err, check_close(f"gram_train {form} ({N}, n={n})", kk, p,
                               2e-6 + 2e-5 * p.abs(), "2e-6 + 2e-5|plain|"))
    if not torch.equal(kk, kk.T):
        raise AssertionError("gram_train is not exactly symmetric")
    B = chol.TRI_INV_BLOCK
    kk = chol._tri_inv_panel(gp.L, B)
    p = chol.tri_inv_panel_plain(gp.L, B)
    err = max(err, check_close(f"tri_inv_panel ({N // B} blocks of {B})", kk,
                               p, 1e-4 * float(p.abs().max()),
                               "1e-4 max|plain|"))
    v = k.gram(torch.rand((1, d), generator=gen, device=dev), gp.x)[0] \
        * gp.mask
    T = torch.tril(cache.Linv)
    for tr in (False, True):
        A = T.abs().T if tr else T.abs()
        err = max(err, check_close(
            f"trimv transpose={tr} ({N})", tv._trimv_pallas(cache.Linv, v, tr),
            tv.trimv_plain(cache.Linv, v, tr), 1e-4 * (A @ v.abs()),
            "1e-4 (|tril L| |v|)"))
    return err


def model_fields(model) -> dict:
    """The tensors of a model of any family that must stay finite."""
    if hasattr(model, "gps"):
        return {f"{k}{j}": getattr(g, k) for j, g in enumerate(model.gps)
                for k in ("L", "alpha")}
    return {k: getattr(model, k) for k in ("L", "alpha", "xb")
            if getattr(model, k, None) is not None}


def bo_run(name: str, bo, dev, gen, iters: int, dim: int = BO_DIM,
           n_final=None):
    """One BOptimizer.optimize run on the card with the launch counts set to
    0 just before it and read just after; checks the run's result (best
    value, samples in the box, finite model; ``n_final`` samples in the
    model, default init + iters).  Returns the state, the launch counts
    and the timings."""
    from limbo_tpu_torch.ops import _cuda

    f = _Recorded(hartmann6)
    clock = _SetupClock()
    bo.stop = bo.stop + (clock,)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    state = bo.optimize(f, dim, generator=gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = dict(_cuda.LAUNCHES)
    setup, loop = clock.t - t0, t1 - clock.t
    n = state.gp.n
    per = {k: v / iters for k, v in launches.items() if v}
    log(f"bo path ({name}): set-up {setup:.3f} s ({bo.init.count} init "
        f"points, capacity {state.gp.capacity}), {iters} iterations "
        f"{loop:.3f} s = {iters / loop:.3f} iters/s; best "
        f"{state.best_value:.6f} (the optimum 3.32237)")
    log(f"  launches: {launches}; per iteration: "
        f"{ {k: round(v, 3) for k, v in per.items()} }")
    if n_final is None:
        n_final = bo.init.count + iters
    if state.iteration != iters or n != n_final:
        raise AssertionError(f"bo path ({name}): {state.iteration} "
                             f"iterations, {n} samples")
    if len(f.ys) != bo.init.count + iters:
        raise AssertionError(f"bo path ({name}): {len(f.ys)} evaluations "
                             f"for {n} samples")
    # the GP stores observations in f32: the best of the f32 roundings is
    # the rounding of the best
    best = float(torch.tensor(max(f.ys), dtype=torch.float32))
    if n != len(f.ys):
        # a sparsified model keeps a subset: its best is the best it kept
        kept = [y for x, y in zip(f.xs, f.ys)
                if bool((torch.from_numpy(x).to(state.gp.x)[None, :]
                         == state.gp.x[:n]).all(dim=1).any())]
        best = float(torch.tensor(max(kept), dtype=torch.float32))
    if state.best_value != best:
        raise AssertionError(f"bo path ({name}): best_value "
                             f"{state.best_value} != max(observed) {best}")
    X = torch.stack([torch.from_numpy(x) for x in f.xs])
    if not (bool(((X >= 0) & (X <= 1)).all())
            and bool(((state.gp.x[:n] >= 0) & (state.gp.x[:n] <= 1)).all())):
        raise AssertionError(f"bo path ({name}): a sample outside [0, 1]^6")
    check_finite(f"bo path ({name})", **model_fields(state.gp))
    log(f"  best_value == max(observed), {n} samples in [0, 1]^{dim}, "
        f"model finite: ok")
    return state, launches, dict(setup_s=setup, loop_s=loop,
                                 iters_per_s=iters / loop, iters=iters,
                                 best=state.best_value,
                                 launches_per_iter=per)


def bo_path(dev, gen):
    """The library's own entry point on the card, at the Hartmann-6
    benchmark's width (d = 6): (a) BOptimizer() at its defaults (Matern-5/2
    + DataMean, UCB, 64 x Rprop(20) from a 1024-point sweep, RandomSampling
    (10), capacity 256) for BO_A_ITERS iterations; (b) BOptimizerHPOpt(
    dim_in=6) (SquaredExpARD, KernelLFOpt(ParallelRepeater(Rprop(100), 4))
    every 10 iterations) for BO_B_ITERS; (c) the cached configuration:
    SquaredExpARD, a BO_C_INIT-point init design (capacity 5120), the K^-1
    cache with deferred appends and a bf16 mirror, an exact rebuild every
    BO_C_REFRESH appends, for BO_C_ITERS iterations."""
    from limbo_tpu_torch.bo import BOptimizer, BOptimizerHPOpt, MaxIterations
    from limbo_tpu_torch.bo import RandomSampling
    from limbo_tpu_torch.kernels import SquaredExpARD

    out, counts = {}, {}
    state, counts["bo_a"], out["a"] = bo_run(
        "a, defaults", BOptimizer(stop=(MaxIterations(BO_A_ITERS),)), dev,
        gen, BO_A_ITERS)
    check_counts("bo path (a)", counts["bo_a"], {"gram": (BO_A_ITERS, None)})
    with uncounted():
        out["a"]["kernel_err"] = bo_kernel_checks("bo path (a)", state.gp,
                                                  None, gen, dev)
        out["a"]["errs"] = check_posterior_exact(state.gp, torch.rand(
            (RESTARTS, BO_DIM), generator=gen, device=dev))

    state, counts["bo_b"], out["b"] = bo_run(
        "b, BOptimizerHPOpt", BOptimizerHPOpt(
            dim_in=BO_DIM, stop=(MaxIterations(BO_B_ITERS),)), dev, gen,
        BO_B_ITERS)
    check_counts("bo path (b)", counts["bo_b"], {"gram": (BO_B_ITERS, None)})
    p = state.gp.kernel.params
    log(f"  learned SquaredExpARD parameters "
        f"{[round(x, 4) for x in p.tolist()]}")
    if torch.equal(p, SquaredExpARD.create(dim=BO_DIM, device=dev).params):
        raise AssertionError("bo path (b): hp-opt left the kernel as it was")
    with uncounted():
        out["b"]["kernel_err"] = bo_kernel_checks("bo path (b)", state.gp,
                                                  None, gen, dev)
        out["b"]["errs"] = check_posterior_exact(state.gp, torch.rand(
            (RESTARTS, BO_DIM), generator=gen, device=dev))
    del state

    bo = BOptimizer(kernel=SquaredExpARD.create(dim=BO_DIM, device=dev),
                    init=RandomSampling(BO_C_INIT),
                    stop=(MaxIterations(BO_C_ITERS),), use_query_cache=True,
                    cache_fast_update="deferred",
                    cache_query_dtype=torch.bfloat16,
                    cache_refresh_period=BO_C_REFRESH)
    state, counts["bo_c"], out["c"] = bo_run("c, cached", bo, dev, gen,
                                             BO_C_ITERS)
    cache = state.cache
    check_finite("bo path (c)", Linv=cache.Linv, Kinv=cache.Kinv,
                 Kinv_q=cache.Kinv_q.float())
    refreshes = BO_C_ITERS // BO_C_REFRESH
    check_counts("bo path (c)", counts["bo_c"], {
        "gram_train": (refreshes, None), "tri_inv_panel": (1 + refreshes, None),
        "trimv": (2 * BO_C_ITERS, 2 * BO_C_ITERS),
        "gram": ((STEPS + 2) * BO_C_ITERS, None),
        "mirror_mm": ((STEPS + 2) * BO_C_ITERS, None)})
    with uncounted():
        out["c"]["kernel_err"] = bo_kernel_checks("bo path (c)", state.gp,
                                                  cache, gen, dev)
        out["c"]["errs"] = check_posterior(state.gp, cache, torch.rand(
            (RESTARTS, BO_DIM), generator=gen, device=dev))
    del state, cache, bo
    torch.cuda.empty_cache()
    return out, counts


def hartmann6_device(dev):
    """-Hartmann6 (hartmann6's function) as a torch function on the card,
    from a (6,) f32 tensor to a (1,) one: the objective optimize_jit
    captures with its step."""
    a, A, P = (t.to(device=dev, dtype=torch.float32)
               for t in (_H_ALPHA, _H6_A, _H6_P))

    def f(x):
        s = torch.sum(A * (x[None, :] - P) ** 2, dim=1)
        return torch.sum(a * torch.exp(-s)).reshape(1)
    return f


def clone_state(gp, cache):
    """A copy of a fitted GP and its cache with storage of its own (the
    cache's absent fields stay None)."""
    import copy

    gp2 = gp.replace(kernel=copy.deepcopy(gp.kernel),
                     mean=copy.deepcopy(gp.mean), **{
                         k: getattr(gp, k).clone()
                         for k in ("x", "y", "L", "alpha", "n_dev")})
    from limbo_tpu_torch.bo.graph import _CACHE_FIELDS

    cache2 = cache.replace(**{
        k: getattr(cache, k).clone() for k in _CACHE_FIELDS
        if getattr(cache, k) is not None})
    return gp2, cache2


def same_bits(a, b) -> bool:
    """Whether two tensors hold the same bits (so -0.0 is not 0.0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = {4: torch.int32, 2: torch.int16, 8: torch.int64, 1: torch.uint8}
    a, b = a.contiguous(), b.contiguous()
    if a.is_floating_point():
        a, b = (t.view(ints[t.element_size()]) for t in (a, b))
    return torch.equal(a, b)


def graph_path(dev, seed: int, iters: int = GRAPH_ITERS):
    """The main path's iteration captured (bo/graph.BOStep): the same
    fitted n = 10k state in two copies and two generators of one seed;
    `iters` iterations (past one flush) eagerly through MainPath on one
    copy and by replay on the other must leave the same bits in the
    proposals, x, y, L, Linv, Kinv, Kinv_q, P, alpha, ay, u_ones and the
    counts (the same kernels run in the same order, on the same draws), with
    the same launches an iteration; then the posterior and the launch
    counts as on the main path, and the captured and uncaptured rates in
    alternated groups.  Returns its numbers."""
    from limbo_tpu_torch.bo.graph import BOStep
    from limbo_tpu_torch.ops import _cuda

    gen = torch.Generator(device=dev).manual_seed(seed)
    path = MainPath(dev, gen)
    t0 = time.perf_counter()
    gp = path.fit()
    cache = path.build(gp)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    gp_e, cache_e = clone_state(gp, cache)
    gens = [torch.Generator(device=dev).manual_seed(seed + 1)
            for _ in range(2)]
    rows = iters + 2 * GRAPH_RATE_GROUPS * GRAPH_RATE_ITERS
    xs_c = torch.full((rows, DIM), torch.nan, device=dev)
    step = BOStep(gp, cache, lambda model, it: path.propose(model, gens[1]),
                  path.objective, gens[1], fast_update="deferred",
                  on_sample=lambda it, x, y: xs_c.index_copy_(
                      0, it.reshape(1), x[None, :]))
    del gp, cache

    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    xs_e = []
    for _ in range(iters):
        x = path.acquire(gp_e, cache_e, gens[0])
        gp_e, cache_e = path.append(gp_e, cache_e, x)
        xs_e.append(x)
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    launches_e = dict(_cuda.LAUNCHES)

    _cuda.reset_launches()
    t0 = time.perf_counter()
    step.step()                        # the warm-up iteration and capture
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters - 1):
        step.step()
    torch.cuda.synchronize()
    t_replay = time.perf_counter() - t0
    launches_c = dict(_cuda.LAUNCHES)
    per_replay = step.launches()
    log(f"graph path: fit + cache build {t_setup:.3f} s; {iters} eager "
        f"iterations {t_eager:.3f} s; captured: warm-up + capture "
        f"{t_capture:.3f} s, {iters - 1} replays {t_replay:.3f} s = "
        f"{(iters - 1) / t_replay:.3f} iters/s (n {N_POINTS} -> "
        f"{step.gp.n}, flushes at base_n {step.cache.base_n})")
    log(f"  launches, eager {launches_e}; captured {launches_c}; per "
        f"replay, by flush: {per_replay}")

    gp_c, cache_c = step.gp, step.cache
    pairs = dict(proposals=(torch.stack(xs_e), xs_c[:iters]),
                 x=(gp_e.x, gp_c.x), y=(gp_e.y, gp_c.y), L=(gp_e.L, gp_c.L),
                 alpha=(gp_e.alpha, gp_c.alpha),
                 mean=(gp_e.mean.value, gp_c.mean.value),
                 n=(gp_e.n_dev, gp_c.n_dev),
                 Linv=(cache_e.Linv, cache_c.Linv),
                 Kinv=(cache_e.Kinv, cache_c.Kinv),
                 Kinv_q=(cache_e.Kinv_q, cache_c.Kinv_q),
                 P=(cache_e.P, cache_c.P), ay=(cache_e.ay, cache_c.ay),
                 u_ones=(cache_e.u_ones, cache_c.u_ones),
                 base_n=(cache_e.base_n_dev, cache_c.base_n_dev))
    differ = [k for k, (a, b) in pairs.items() if not same_bits(a, b)]
    if differ:
        raise AssertionError(f"graph path: captured and eager runs differ "
                             f"in {differ}")
    log(f"  captured == eager, bit for bit, over {iters} iterations: "
        f"{', '.join(pairs)}: ok")
    if not (gp_c.n == gp_e.n == N_POINTS + iters
            and cache_c.base_n == cache_e.base_n != N_POINTS
            and int(gp_c.n_dev) == gp_c.n
            and int(cache_c.base_n_dev) == cache_c.base_n):
        raise AssertionError(f"graph path: counts n {gp_c.n} / {gp_e.n}, "
                             f"base_n {cache_c.base_n} / {cache_e.base_n}")
    del gp_e, cache_e, xs_e, pairs
    torch.cuda.empty_cache()
    check_finite("graph path", L=gp_c.L, alpha=gp_c.alpha,
                 Linv=cache_c.Linv, Kinv=cache_c.Kinv)
    want = {"gram": ((STEPS + 2) * iters, (STEPS + 2) * iters),
            "mirror_mm": ((STEPS + 2) * iters, (STEPS + 2) * iters),
            "trimv": (2 * iters, 2 * iters)}
    check_counts("graph path (eager)", launches_e, want)
    check_counts("graph path (captured)", launches_c, want)
    if any(launches_c[k] != launches_e[k] for k in launches_c):
        raise AssertionError("graph path: the captured run's launches are "
                             "not the eager run's")
    with uncounted():
        errs = check_posterior(gp_c, cache_c, torch.rand(
            (RESTARTS, DIM), generator=gen, device=dev))

    # the rates, captured and uncaptured alternated on the same state
    best = {"captured": math.inf, "uncaptured": math.inf}
    for g in range(GRAPH_RATE_GROUPS):
        order = ("captured", "uncaptured")
        for mode in order if g % 2 == 0 else order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GRAPH_RATE_ITERS):
                step.step(eager=mode == "uncaptured")
            torch.cuda.synchronize()
            best[mode] = min(best[mode], (time.perf_counter() - t0)
                             / GRAPH_RATE_ITERS)
    check_finite("graph path", L=gp_c.L, alpha=gp_c.alpha)
    rates = {k: 1.0 / v for k, v in best.items()}
    log(f"  alternated, best of {GRAPH_RATE_GROUPS} groups of "
        f"{GRAPH_RATE_ITERS}: captured {rates['captured']:.3f} iters/s, "
        f"uncaptured {rates['uncaptured']:.3f} iters/s ({card_line()})")
    del step, gp_c, cache_c
    torch.cuda.empty_cache()
    return dict(iters_per_s=rates, setup_s=t_setup, eager_s=t_eager,
                capture_s=t_capture, replay_s=t_replay,
                launches_per_replay={str(k): v for k, v in
                                     per_replay.items()},
                errs=errs), launches_e, launches_c


def check_history(where: str, state, hist, iters: int, live: int) -> None:
    """optimize_jit's history: `live` live rows then NaN rows and -inf
    aggregates, `best` monotone from the init design's best, its last value
    the state's best_value, the samples in the box."""
    xs, ys, best = hist["samples"], hist["observations"], hist["best"]
    n_eff = int(hist["effective_iterations"])
    if n_eff != live or xs.shape != (iters, state.gp.dim_in):
        raise AssertionError(f"{where}: {n_eff} effective iterations, "
                             f"expected {live}; samples {tuple(xs.shape)}")
    if not (bool(torch.isfinite(xs[:live]).all())
            and bool(torch.isnan(xs[live:]).all())
            and bool(torch.isnan(ys[live:]).all())):
        raise AssertionError(f"{where}: live rows not finite or frozen rows "
                             "not NaN")
    if not bool((torch.diff(best) >= 0).all()):
        raise AssertionError(f"{where}: best is not monotone")
    if float(best[-1]) != state.best_value:
        raise AssertionError(f"{where}: best {float(best[-1])} != "
                             f"best_value {state.best_value}")
    if not bool(((xs[:live] >= 0) & (xs[:live] <= 1)).all()):
        raise AssertionError(f"{where}: a sample outside [0, 1]^d")
    if not torch.equal(state.gp.x[state.gp.n - live:state.gp.n], xs[:live]):
        raise AssertionError(f"{where}: the history's samples are not the "
                             "GP's")


def jit_run(name: str, bo, dev, gen, iters: int, live: int):
    """One BOptimizer.optimize_jit run on the card with the launch counts
    set to 0 just before it and read just after; checks its history."""
    from limbo_tpu_torch.ops import _cuda

    f = hartmann6_device(dev)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    state, hist = bo.optimize_jit(f, BO_DIM, generator=gen)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    check_history(f"optimize_jit ({name})", state, hist, iters, live)
    check_finite(f"optimize_jit ({name})", L=state.gp.L,
                 alpha=state.gp.alpha)
    log(f"optimize_jit ({name}): {t:.3f} s in all ({bo.init.count} init "
        f"points, capacity {state.gp.capacity}, {live} of {iters} "
        f"iterations live); best {state.best_value:.6f}; launches "
        f"{launches}")
    return state, launches, dict(seconds=t, best=state.best_value,
                                 live=live)


def jit_path(dev, gen):
    """BOptimizer.optimize_jit on -Hartmann6 as a device function: (a) the
    defaults cut to JIT_A_ITERS iterations (the exact append, its flag read
    once an iteration); (c) bo_path's cached configuration for JIT_C_ITERS;
    (f) the defaults with MaxPredictedValue(ratio=0) beside MaxIterations,
    which must freeze after its first iteration.  Each checks its history
    and its launches; (a) and (c) their posteriors."""
    from limbo_tpu_torch.bo import (BOptimizer, MaxIterations,
                                    MaxPredictedValue, RandomSampling)
    from limbo_tpu_torch.kernels import SquaredExpARD

    out, counts = {}, {}
    state, counts["jit_a"], out["a"] = jit_run(
        "a, defaults", BOptimizer(stop=(MaxIterations(JIT_A_ITERS),)), dev,
        gen, JIT_A_ITERS, JIT_A_ITERS)
    check_counts("optimize_jit (a)", counts["jit_a"],
                 {"gram": (JIT_A_ITERS, JIT_A_ITERS)})
    with uncounted():
        out["a"]["errs"] = check_posterior_exact(state.gp, torch.rand(
            (RESTARTS, BO_DIM), generator=gen, device=dev))

    bo = BOptimizer(kernel=SquaredExpARD.create(dim=BO_DIM, device=dev),
                    init=RandomSampling(BO_C_INIT),
                    stop=(MaxIterations(JIT_C_ITERS),), use_query_cache=True,
                    cache_fast_update="deferred",
                    cache_query_dtype=torch.bfloat16)
    state, counts["jit_c"], out["c"] = jit_run(
        "c, cached", bo, dev, gen, JIT_C_ITERS, JIT_C_ITERS)
    per = (STEPS + 2) * JIT_C_ITERS
    check_counts("optimize_jit (c)", counts["jit_c"], {
        "tri_inv_panel": (1, None), "gram": (per, per),
        "mirror_mm": (per, per), "trimv": (2 * JIT_C_ITERS, 2 * JIT_C_ITERS)})
    if state.cache.base_n == BO_C_INIT:
        raise AssertionError("optimize_jit (c): no deferred flush happened")
    with uncounted():
        out["c"]["errs"] = check_posterior(state.gp, state.cache, torch.rand(
            (RESTARTS, BO_DIM), generator=gen, device=dev))
    del state, bo
    torch.cuda.empty_cache()

    bo = BOptimizer(stop=(MaxIterations(JIT_F_ITERS),
                          MaxPredictedValue(ratio=0.0)))
    state, counts["jit_f"], out["f"] = jit_run(
        "f, frozen by MaxPredictedValue(ratio=0)", bo, dev, gen, JIT_F_ITERS,
        1)
    if state.gp.n != bo.init.count + 1:
        raise AssertionError("optimize_jit (f): the state moved after its "
                             "stop")
    return out, counts


def sym_eig_entry(C) -> dict:
    """The eigensolver kernel against its plain version (the same Jacobi
    rotations in PyTorch operations) on a CMA-ES covariance of the path:
    eigenvalues within 1e-5 max|w|, the reconstruction V diag(w) V^T
    within 1e-5 max|C|, and each eigenvector whose eigenvalue is at least
    1e-2 max|w| from its neighbours within 2e-3 (an f32 rounding of C moves
    it by ~1e-7 / 1e-2); timed against it and against torch.linalg.eigh
    (which waits on the host, so CUDA events, not a graph)."""
    from limbo_tpu_torch.ops.sym_eig import SWEEPS, sym_eig, sym_eig_plain

    B, d = C.shape[0], C.shape[-1]
    w, V = sym_eig(C)
    wp, Vp = sym_eig_plain(C)
    scale = float(wp.abs().max())
    log(f"sym_eig on a CMA-ES covariance ({B} x {d} x {d}, f32), "
        f"eigenvalues {[round(float(x), 6) for x in wp[0]]}:")
    err = check_close("sym_eig eigenvalues", w, wp, 1e-5 * scale,
                      "1e-5 max|w|")
    rec = V @ torch.diag_embed(w) @ V.transpose(-1, -2)
    check_close("sym_eig V diag(w) V^T", rec, C, 1e-5 * float(C.abs().max()),
                "1e-5 max|C|")
    gap = torch.diff(wp, dim=-1)
    edge = torch.full_like(gap[..., :1], math.inf)
    sep = torch.minimum(torch.cat([edge, gap], -1), torch.cat([gap, edge], -1))
    cols = sep >= 1e-2 * scale                                # (B, d)
    dv = torch.where(cols[:, None, :], (V - Vp).abs(), 0.0)
    if not bool((dv <= 2e-3).all()):
        raise AssertionError(f"sym_eig eigenvectors: max |err| "
                             f"{float(dv.max()):.3e} over 2e-3")
    err = max(err, float(dv.max()))
    log(f"  sym_eig eigenvectors ({int(cols.sum())} of {B * d} separated): "
        f"max |err| {float(dv.max()):.3e}, tolerance 2e-3: ok")
    ms = cuda_ms(lambda: sym_eig(C))
    plain = cuda_ms(lambda: sym_eig_plain(C), reps=2)
    lib = event_ms(lambda: torch.linalg.eigh(C), reps=20)
    # the work of the fixed sweeps: per rotation ~24 operations for
    # (t, c, s) and the diagonal, 6 for each of the d - 2 other rows and
    # 6 for each of the d eigenvector rows
    ops = B * SWEEPS * d * (d - 1) / 2 * (24 + 6 * (d - 2) + 6 * d)
    bnd = bound_ms(C.numel() * 4 + (w.numel() + V.numel()) * 4, ops)
    log(f"  sym_eig: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"torch.linalg.eigh {lib:.4f} ms (with its host check), bound "
        f"{bnd[0]:.2e} ms ({bnd[1]}; latency-bound)")
    return dict(route="cuda", source="limbo_tpu_torch/csrc/sym_eig.cu",
                replaces="limbo_tpu/opt/cmaes.py:93 (jnp.linalg.eigh, no "
                "Pallas kernel)", max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib)


def _ref_median(path: str) -> float:
    import numpy as np

    return float(np.median(np.loadtxt(path, ndmin=2)[:, 0]))


def suite_path(dev, gen):
    """The benchmark suites through their entry points.  (a) bo_suite.
    run_suite runs each of the 7 default_variants() on Hartmann6 (10 init
    points, 190 iterations, f32, one replicate, every run through
    optimize_jit, so captured), with the launch counts set to 0 just before
    each variant and read just after: each must equal SUITE_COUNTS, the
    accuracy must be finite and the history (check_history) whole; each
    accuracy is printed beside the reference's median
    (benchmark_results/summary.json, not a check).  The gram kernel is then
    held against its plain version on limbo_def's final GP, and the
    eigensolver on a CMA-ES covariance of the card.  (b) regression_suite.
    run_regression_suite on RobotArm d8 at n = 600, both models, one
    replicate and one oracle replicate, precise: finite MSEs, the launches
    of gram and gram_train recorded (gram_train at least once: the f32
    multi-start at capacity 768), each MSE beside the reference's median
    and the oracle's; gram_train is held against its plain version on the
    run's inputs at capacity 768."""
    import dataclasses
    import tempfile

    from limbo_tpu_torch.benchmarks import bo_suite
    from limbo_tpu_torch.benchmarks import regression_suite as rs
    from limbo_tpu_torch.benchmarks.functions import HARTMANN6
    from limbo_tpu_torch.benchmarks.regression_functions import ROBOT_ARM
    from limbo_tpu_torch.kernels import SquaredExpARD
    from limbo_tpu_torch.kernels.base import effective_jitter
    from limbo_tpu_torch.ops import _cuda, gram_pallas as gp_ops
    from limbo_tpu_torch.opt import Cmaes

    with open("benchmark_results/summary.json") as fh:
        ref = json.load(fh)
    out, counts, runs = {"bo": {}, "regression": {}}, {}, []
    make = bo_suite.make_optimizer

    def keep(*args, **kwargs):
        """make_optimizer, its optimize_jit's (state, history) kept."""
        bo = make(*args, **kwargs)
        jit = bo.optimize_jit

        def recorded(*a, **k):
            runs.append(jit(*a, **k))
            return runs[-1]
        bo.optimize_jit = recorded
        return bo

    bo_suite.make_optimizer = keep
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for v in bo_suite.default_variants():
                torch.cuda.synchronize()
                _cuda.reset_launches()
                t0 = time.perf_counter()
                row = bo_suite.run_suite(
                    [v], [HARTMANN6], nb_reps=1, n_init=SUITE_INIT,
                    n_iters=SUITE_ITERS, out_dir=tmp, verbose=False,
                    device=dev)[f"{v.name}/Hartmann6"]
                t = time.perf_counter() - t0
                launches = dict(_cuda.LAUNCHES)
                where = f"suite path ({v.name})"
                state, hist = runs[-1]
                if not math.isfinite(row["accuracy"]):
                    raise AssertionError(f"{where}: accuracy "
                                         f"{row['accuracy']}")
                check_history(where, state, hist, SUITE_ITERS, SUITE_ITERS)
                want = SUITE_COUNTS[v.name]
                check_counts(where, launches, {
                    k: (want.get(k, 0), want.get(k, 0)) for k in launches})
                r = ref.get(f"{v.name}/Hartmann6", {}).get("accuracy")
                log(f"{where}: accuracy {row['accuracy']:.6f} (the "
                    f"reference's median over 10: {r}); {row['time_ms']:.1f}"
                    f" ms, of it warm-up and capture {row['compile_ms']:.1f}"
                    f" ms; launches {launches}: as expected")
                out["bo"][v.name] = dict(
                    accuracy=row["accuracy"], ref_median=r,
                    time_ms=row["time_ms"], capture_ms=row["compile_ms"],
                    seconds=t)
                counts[f"suite_{v.name}"] = launches
                if v.name == "limbo_def":
                    final_gp = state.gp
            del state, hist
            runs.clear()
            with uncounted():
                out["bo"]["gram_err"] = bo_kernel_checks(
                    "suite path (limbo_def)", final_gp, None, gen, dev)
                # a covariance of CMA-ES on the card: the suite's
                # generation (16 of Hartmann6's 6 dims), 10 generations in
                cm = Cmaes(iterations=SUITE_CMA_GENS, pop_size=16)
                f = HARTMANN6.make(dev, torch.float32)
                st = cm.init_state(torch.full((6,), 0.5, device=dev), 1)
                z = torch.randn((10, 1, 16, 6), generator=gen, device=dev)
                for zt in z:
                    st = cm.generation(lambda X: -f(X), st, zt)
                sym = sym_eig_entry(st.C)

            fn = dataclasses.replace(ROBOT_ARM, dims=(8,))
            torch.cuda.synchronize()
            _cuda.reset_launches()
            t0 = time.perf_counter()
            summ = rs.run_regression_suite(
                functions=[fn], points=(REG_N,), nb_reps=1, oracle_reps=1,
                out_dir=tmp, dtype=torch.float32, verbose=False,
                precise=True, device=dev)
            t = time.perf_counter() - t0
            launches = dict(_cuda.LAUNCHES)
    finally:
        bo_suite.make_optimizer = make
    check_counts("suite path (regression)", launches,
                 {"gram_train": (1, None)})
    counts["suite_regression"] = launches
    for spec in rs.DEFAULT_MODELS:
        tag = f"RobotArm_d8_n{REG_N}_{spec.name}"
        row = summ[tag]
        if not (math.isfinite(row["mse"])
                and math.isfinite(row["oracle_mse"])):
            raise AssertionError(f"suite path ({tag}): mse {row['mse']}, "
                                 f"oracle {row['oracle_mse']}")
        r = _ref_median(f"regression_results/{tag}.dat")
        log(f"suite path ({tag}): mse {row['mse']:.6g} (the reference's "
            f"median over 10: {r}; the oracle's {row['oracle_mse']:.6g}); "
            f"learn {row['learn_ms']:.1f} ms, query {row['query_ms']:.2f} "
            f"ms, oracle learn {row['oracle_learn_ms']:.1f} ms")
        out["regression"][spec.name] = dict(
            mse=row["mse"], ref_median=r, oracle_mse=row["oracle_mse"],
            learn_ms=row["learn_ms"], query_ms=row["query_ms"],
            oracle_learn_ms=row["oracle_learn_ms"])
    log(f"suite path (regression): {t:.1f} s in all; launches {launches}")
    out["regression"]["seconds"] = t
    # gram_train on the run's inputs (replicate 0's draws) at capacity 768
    with uncounted():
        make_data = rs._make_runner(fn, 8, REG_N, rs.DEFAULT_MODELS[0],
                                    device=dev)[0]
        U = make_data(torch.Generator(device=dev).manual_seed(13))[0]
        X = torch.zeros((REG_CAPACITY, 8), device=dev)
        X[:REG_N] = U
        k = SquaredExpARD.create(dim=8, noise=0.01, device=dev)
        form, X2, sf2, inv_l = k._fused_train_args(X)
        dadd = k.noise + effective_jitter(torch.float32) * torch.clamp(
            sf2, min=1.0)
        kk = gp_ops.gram_train_pallas(X2, sf2, inv_l, dadd, REG_N, form)
        p = gp_ops.gram_train_plain(X2, sf2, inv_l, dadd, REG_N, form)
        out["regression"]["gram_train_err"] = check_close(
            f"gram_train {form} ({REG_CAPACITY}, n={REG_N}, the run's U)",
            kk, p, 2e-6 + 2e-5 * p.abs(), "2e-6 + 2e-5|plain|")
    torch.cuda.empty_cache()
    return out, counts, sym


# ---------------------------------------------------------------------------
# slice 9: the lite cache at n = 32k, the immediate append modes, the other
# model families
# ---------------------------------------------------------------------------

def f32_panel(A, r0, r1, chunk: int = 2048):
    """Rows r0:r1 of A^T A for a lower-triangular A (N, N), in f64, and of
    |A|^T |A|, summed over row chunks of A (no f64 N x N copy)."""
    N = A.shape[0]
    acc = torch.zeros((r1 - r0, N), dtype=torch.float64, device=A.device)
    acc_abs = torch.zeros_like(acc)
    for k0 in range(r0, N, chunk):
        blk = A[k0:k0 + chunk].double()
        cols = blk[:, r0:r1]
        acc += cols.T @ blk
        acc_abs += cols.abs().T @ blk.abs()
    return acc, acc_abs


def check_mirror_panels(where, mirror, Linv, rows, control=None) -> float:
    """Row panels of a bf16 mirror against (Linv^T Linv) in f64: within one
    bf16 rounding (2^-8 relative: 8 significant bits) of the f32 panel
    product, whose own rounding is bounded by sqrt(N) 2^-24
    (|Linv|^T |Linv|).  ``control``:
    rows of an earlier mirror that must miss the same limit somewhere."""
    N = Linv.shape[0]
    err, missed = 0.0, 0
    for r0, r1 in rows:
        exact, absp = f32_panel(Linv, r0, r1)
        delta = N ** 0.5 * F32_U * absp
        tol = 2.0 ** -8 * (exact.abs() + delta) + delta
        err = max(err, check_close(
            f"{where}: mirror rows {r0}:{r1} vs f64 Linv^T Linv",
            mirror[r0:r1], exact, tol,
            "2^-8 (|exact| + d) + d, d = sqrt(N) 2^-24 |Linv|^T|Linv|"))
        if control is not None:
            missed += int((~((control[(r0, r1)].double() - exact).abs()
                             <= tol)).sum())
        del exact, absp, delta, tol
    if control is not None:
        log(f"  control: the mirror before the flush misses that limit in "
            f"{missed} entries")
        if not missed:
            raise AssertionError(f"{where}: the pre-flush mirror passes the "
                                 "post-flush mirror check")
    return err


def kernel_rows_at(where, gp, cache, gen, dev) -> dict:
    """Each kernel of the lite path held against its plain version on the
    run's own state at N = LITE_CAPACITY (bo_kernel_checks, then the panel
    factor on the first block of the training covariance and the mirror
    product on the run's bf16 mirror), then timed there: CUDA-graph replay
    (fewer calls for the N x N outputs), and the factorization, the
    blocked inverse and the mirror build with CUDA events.  Returns
    per-kernel rows for the kernels JSON line."""
    from limbo_tpu_torch.kernels.base import effective_jitter
    from limbo_tpu_torch.models import gp as gp_mod
    from limbo_tpu_torch.ops import chol, gram_pallas as gp_ops, mirror
    from limbo_tpu_torch.ops import trimv as tv

    err = bo_kernel_checks(where, gp, cache, gen, dev)
    k = gp.kernel
    N, n, d = gp.capacity, gp.n, gp.x.shape[1]
    form, X2, sf2, inv_l = k._fused_train_args(gp.x)
    dadd = k.noise + effective_jitter(torch.float32) * torch.clamp(sf2,
                                                                   min=1.0)
    B = chol.PANEL_BLOCK
    D = gp_ops.gram_train_pallas(X2[:B].contiguous(), sf2, inv_l, dadd, B,
                                 form)
    Lk, Vk = chol._panel_factor_pallas(D)
    Lp, Vp = chol.panel_factor_plain(D)
    err_pf = max(check_close("panel L11 (first block)", Lk, Lp,
                             1e-4 * float(Lp.abs().max()), "1e-4 max|plain|"),
                 check_close("panel L11^-T (first block)", Vk, Vp,
                             1e-4 * float(Vp.abs().max()), "1e-4 max|plain|"))
    Kq = cache.Kinv_q
    err_m = 0.0
    rows = {}
    for q in (RESTARTS, SWEEP):
        Xq = torch.rand((q, d), generator=gen, device=dev)
        ks = k.gram(Xq, gp.x) * gp.mask[None, :]
        t = mirror.mirror_mm(ks, Kq)
        kb = ks.to(torch.bfloat16).double()
        t64 = torch.zeros((q, N), dtype=torch.float64, device=dev)
        scale = torch.zeros_like(t64)
        for c0 in range(0, N, 4096):
            K64 = Kq[c0:c0 + 4096].double()
            t64 += kb[:, c0:c0 + 4096] @ K64
            scale += kb[:, c0:c0 + 4096].abs() @ K64.abs()
        del K64
        err_m = max(err_m, check_close(
            f"mirror product ({q}x{N}) vs the f64 product of its operands",
            t, t64, N ** 0.5 * F32_U * scale,
            "sqrt(N) 2^-24 (|ks| @ |Kinv_q|)"))
        del t64, scale, t
        X1 = k._fused_train_args(Xq)[1]
        rows[q] = dict(
            gram=cuda_ms(lambda: gp_ops.gram_pallas(X1, X2, sf2, inv_l,
                                                    form)),
            gram_plain=cuda_ms(lambda: gp_ops.gram_plain(
                X1, X2, sf2, inv_l, form), reps=5),
            mirror=cuda_ms(lambda: mirror.mirror_mm(ks, Kq), reps=5),
            mirror_plain=cuda_ms(lambda: mirror.mirror_mm_plain(ks, Kq),
                                 reps=2),
            mirror_lib=cuda_ms(lambda: torch.mm(ks.to(torch.bfloat16), Kq,
                                                out_dtype=torch.float32),
                               reps=5),
            b_gram=bound_ms((q * d + N * d + q * N) * 4,
                            2 * d * q * N + 2 * d * (q + N) + 10 * q * N),
            b_mirror=bound_ms(N * N * 2 + q * N * 6, 2 * q * N * N,
                              PEAK_BF16_OPS))
    out = {}
    v = k.gram(torch.rand((1, d), generator=gen, device=dev), gp.x)[0] \
        * gp.mask
    tr = {t: cuda_ms(lambda: tv._trimv_pallas(cache.Linv, v, t), reps=5)
          for t in (False, True)}
    tr_plain = cuda_ms(lambda: tv.trimv_plain(cache.Linv, v), reps=2)
    tr_lib = cuda_ms(lambda: torch.mv(cache.Linv, v), reps=5)
    gt = cuda_ms(lambda: gp_ops.gram_train_pallas(X2, sf2, inv_l, dadd, n,
                                                  form), reps=3)
    gt_plain = cuda_ms(lambda: gp_ops.gram_train_plain(X2, sf2, inv_l, dadd,
                                                       n, form), reps=1)
    ti = cuda_ms(lambda: chol._tri_inv_panel(gp.L, chol.TRI_INV_BLOCK))
    ti_plain = cuda_ms(lambda: chol.tri_inv_panel_plain(
        gp.L, chol.TRI_INV_BLOCK), reps=1)
    nb = N // chol.TRI_INV_BLOCK
    Dd = torch.tril(chol._diag_blocks(gp.L, chol.TRI_INV_BLOCK)).contiguous()
    eye = torch.eye(chol.TRI_INV_BLOCK, device=dev).expand(nb, B, B)
    ti_lib = cuda_ms(lambda: torch.linalg.solve_triangular(Dd, eye,
                                                           upper=False))
    del Dd, eye
    pf = cuda_ms(lambda: chol._panel_factor_pallas(D))
    pf_plain = cuda_ms(lambda: chol.panel_factor_plain(D))
    pf_lib = cuda_ms(lambda: torch.linalg.solve_triangular(
        torch.linalg.cholesky_ex(D)[0], torch.eye(B, device=dev),
        upper=False))
    Kt = gp_ops.gram_train_pallas(X2, sf2, inv_l, dadd, n, form)
    fact = event_ms(lambda: chol.cholesky_blocked(Kt), reps=1)
    fact_lib = event_ms(lambda: torch.linalg.cholesky_ex(Kt), reps=1)
    del Kt
    inv = event_ms(lambda: chol.tri_inv_blocked(gp.L), reps=1)
    Linv = cache.Linv
    mbuf = torch.empty_like(cache.Kinv_q)
    build = event_ms(lambda: gp_mod._mirror_from_linv(
        Linv, torch.bfloat16, out=mbuf), reps=1)
    del mbuf
    fb = bound_ms(2 * N * N * 4, N ** 3 / 3)
    # the panels skip Linv's zero rows: N^3 multiply-adds' worth of work
    mb = bound_ms(N * N * 4 / 2 + N * N * 2, N ** 3)
    log(f"{where}: kernel times at N = {N} (CUDA-graph replay; events for "
        f"the factorization, the inverse and the mirror build):")
    for q in (RESTARTS, SWEEP):
        r = rows[q]
        log(f"  gram ({q}x{N}) {r['gram']:.4f} ms, plain "
            f"{r['gram_plain']:.4f}, bound {r['b_gram'][0]:.4f} "
            f"({r['b_gram'][1]}); mirror {r['mirror']:.4f} ms, plain "
            f"{r['mirror_plain']:.4f}, torch.mm(bf16) {r['mirror_lib']:.4f}, "
            f"bound {r['b_mirror'][0]:.4f} ({r['b_mirror'][1]})")
    b_tr = bound_ms((N * (N + 1) / 2 + 2 * N) * 4, N * (N + 1))
    b_gt = bound_ms((N * d + N * N) * 4, 2 * d * N * N + 10 * N * N)
    b_ti = bound_ms((nb * B * (B + 1) / 2 + nb * B * B) * 4, nb * B ** 3 / 3)
    b_pf = bound_ms(3 * B * B * 4, 2 * B ** 3 / 3)
    log(f"  trimv {tr[False]:.4f} / {tr[True]:.4f} ms (L v / L^T v), plain "
        f"{tr_plain:.4f}, torch.mv {tr_lib:.4f}, bound {b_tr[0]:.4f}; "
        f"gram_train {gt:.4f} ms, plain {gt_plain:.4f}, bound "
        f"{b_gt[0]:.4f}; tri_inv_panel ({nb} blocks) {ti:.4f} ms, plain "
        f"{ti_plain:.4f}, batched solve_triangular {ti_lib:.4f}, bound "
        f"{b_ti[0]:.4f}; panel_factor {pf:.4f} ms, plain {pf_plain:.4f}, "
        f"library {pf_lib:.4f}")
    log(f"  factorization ({nb} panels) {fact:.1f} ms, cholesky_ex "
        f"{fact_lib:.1f} ms, bound {fb[0]:.1f} ({fb[1]}); tri_inv_blocked "
        f"{inv:.1f} ms, bound {fb[0]:.1f}; _mirror_from_linv {build:.1f} ms,"
        f" bound {mb[0]:.1f} ({mb[1]})")
    q64, q1k = rows[RESTARTS], rows[SWEEP]
    out["gram"] = dict(ms=q1k["gram"], plain_ms=q1k["gram_plain"],
                       bound_ms=q1k["b_gram"][0], at_q64=dict(
                           ms=q64["gram"], plain_ms=q64["gram_plain"],
                           bound_ms=q64["b_gram"][0]))
    out["gram_train"] = dict(ms=gt, plain_ms=gt_plain, bound_ms=b_gt[0])
    out["trimv"] = dict(ms=(tr[False] + tr[True]) / 2, plain_ms=tr_plain,
                        library_ms=tr_lib, bound_ms=b_tr[0])
    out["tri_inv_panel"] = dict(ms=ti, plain_ms=ti_plain, library_ms=ti_lib,
                                bound_ms=b_ti[0], blocked_ms=inv)
    out["panel_factor"] = dict(ms=pf, plain_ms=pf_plain, library_ms=pf_lib,
                               bound_ms=b_pf[0], factorization_ms=fact,
                               factorization_library_ms=fact_lib,
                               factorization_bound_ms=fb[0])
    out["mirror_mm"] = dict(ms=q64["mirror"], plain_ms=q64["mirror_plain"],
                            library_ms=q64["mirror_lib"],
                            bound_ms=q64["b_mirror"][0], at_q1024=dict(
                                ms=q1k["mirror"],
                                plain_ms=q1k["mirror_plain"],
                                library_ms=q1k["mirror_lib"],
                                bound_ms=q1k["b_mirror"][0]),
                            build_ms=build, build_bound_ms=mb[0])
    out["max_abs_err"] = max(err, err_pf, err_m)
    return out


def lite_path(dev, gen):
    """scripts/large_n_bench.py --lite 32768, not cut: n = 32,768, d = 8,
    capacity 33,280, SquaredExpARD (l = 0.3, noise 0.09) + DataMean, the
    lite cache (Linv, a bf16 mirror, defer_m = 256, no f32 K^-1), then
    LITE_ITERS iterations of RandomRestarts(Rprop(20), 64, 1024) on UCB
    (mu + 0.5 sigma), each followed by a deferred append.  Then one more
    append and a forced flush (eager), replayed on a clone inside BOStep's
    flush graph (the same bits).  Checks: finite state; peak memory of the
    build and of the flush (less than one f32 N x N above what stays
    resident); the launch counts; the posterior against f64 after the
    iterations and after the flush (check_posterior_exact); the mirror
    after the flush against f64 Linv^T Linv on row panels, with the
    pre-flush mirror as a control that must fail; and, after the memory
    readings, each kernel against its plain version at the run's shapes.
    Returns its numbers, its launches and the kernels' rows."""
    from limbo_tpu_torch.bo.graph import _CACHE_FIELDS, BOStep
    from limbo_tpu_torch.models import gp as gp_mod
    from limbo_tpu_torch.ops import _cuda

    N = LITE_CAPACITY
    nn4 = N * N * 4
    path = MainPath(dev, gen, n=LITE_N, capacity=N, ell=HP_ELL,
                    noise=HP_NOISE, y_noise=HP_Y_NOISE)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    gp = path.fit()
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache = gp_mod.QueryCache.build(gp, with_Linv=True,
                                    qdtype=torch.bfloat16,
                                    defer_m=LITE_DEFER_M, lite=True)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    build_over = torch.cuda.max_memory_allocated() - resident
    if cache.Kinv is not None or cache.Kinv_q.dtype != torch.bfloat16:
        raise AssertionError("lite path: the cache is not lite")
    gp, cache, t_iters, t_first = bo_iterations(path, gp, cache, LITE_ITERS)
    launches = dict(_cuda.LAUNCHES)
    log(f"lite path: fit {t_fit:.3f} s, lite cache build {t_build:.3f} s "
        f"(resident {resident / 1e9:.3f} GB; the build's peak above it "
        f"{build_over / 1e9:.3f} GB, limit one f32 N x N, "
        f"{nn4 / 1e9:.3f} GB); {LITE_ITERS} iterations {t_iters:.3f} s = "
        f"{LITE_ITERS / t_iters:.3f} iters/s (first {t_first:.3f} s)")
    log(f"  launches: {launches}")
    if not build_over < nn4:
        raise AssertionError("lite path: the build allocated an f32 N x N "
                             "beyond its resident state")
    check_finite("lite path", L=gp.L, alpha=gp.alpha, Linv=cache.Linv,
                 Kinv_q=cache.Kinv_q.float())
    per = (STEPS + 2) * LITE_ITERS
    check_counts("lite path", launches, {
        "panel_factor": (N // 128, N // 128), "tri_inv_panel": (1, 1),
        "gram_train": (1, 1), "gram": (per, per), "mirror_mm": (per, per),
        "trimv": (2 * LITE_ITERS, 2 * LITE_ITERS)})
    with uncounted():
        errs = dict(iters=check_posterior_exact(gp, torch.rand(
            (RESTARTS, DIM), generator=gen, device=dev)))

    # the flush: one append, then one with the flush forced, eagerly on
    # the state and by BOStep's replays on a clone (the first step is its
    # warm-up and capture, the second a replay of the flush graph)
    pts = torch.rand((2, DIM), generator=gen, device=dev)
    gp_c, cache_c = clone_state(gp, cache)
    w = gp_mod._panel_width(N)
    last = (N // w - 1) * w                 # holds the appended rows
    panels = [(0, w), (N // 2 // w * w, N // 2 // w * w + w), (last, N)]
    before = {r: cache.Kinv_q[r[0]:r[1]].clone() for r in panels}
    _cuda.reset_launches()
    gp, cache = gp_mod.add_sample_cached(gp, cache, pts[0],
                                         path.objective(pts[0]),
                                         fast_update="deferred", flush=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gp, cache = gp_mod.add_sample_cached(gp, cache, pts[1],
                                         path.objective(pts[1]),
                                         fast_update="deferred", flush=True)
    torch.cuda.synchronize()
    t_flush = time.perf_counter() - t0
    flush_over = torch.cuda.max_memory_allocated() \
        - torch.cuda.memory_allocated()
    log(f"lite path: the forced flush {t_flush:.3f} s (its peak above the "
        f"resident state {flush_over / 1e9:.3f} GB, limit "
        f"{nn4 / 1e9:.3f} GB); base_n {cache.base_n}")
    if not flush_over < nn4:
        raise AssertionError("lite path: the flush allocated an f32 N x N "
                             "beyond its resident state")
    if cache.base_n != LITE_N + LITE_ITERS + 2 or bool(cache.P.any()):
        raise AssertionError("lite path: the flush did not happen")
    step = BOStep(gp_c, cache_c, lambda model, it: pts.index_select(
        0, it.reshape(1))[0], path.objective, gen, fast_update="deferred")
    del gp_c, cache_c
    step.step(flush=False)
    step.step(flush=True)
    launches_flush = dict(_cuda.LAUNCHES)
    pairs = {k: (getattr(gp, k), getattr(step.gp, k))
             for k in ("x", "y", "L", "alpha", "n_dev")}
    pairs["mean"] = (gp.mean.value, step.gp.mean.value)
    pairs.update({k: (getattr(cache, k), getattr(step.cache, k))
                  for k in _CACHE_FIELDS if getattr(cache, k) is not None})
    differ = [k for k, (a, b) in pairs.items() if not same_bits(a, b)]
    if differ or step.cache.Kinv is not None or step.cache.K is not None:
        raise AssertionError(f"lite path: the captured flush differs from "
                             f"the eager one in {differ}")
    if not (step.graphs.graphs and True in step.graphs.graphs
            and step.cache.base_n == cache.base_n):
        raise AssertionError("lite path: the flush graph did not replay")
    log(f"  the flush replayed in BOStep's flush graph == eager, bit for "
        f"bit: {', '.join(pairs)}: ok; launches of the two appends, eager "
        f"and captured: {launches_flush}")
    check_counts("lite path (flush)", launches_flush,
                 {"trimv": (8, 8), "mirror_mm": (0, 0)})
    del step
    torch.cuda.empty_cache()
    check_finite("lite path (flush)", L=gp.L, alpha=gp.alpha,
                 Linv=cache.Linv, Kinv_q=cache.Kinv_q.float())
    with uncounted():
        errs["flush"] = check_posterior_exact(gp, torch.rand(
            (RESTARTS, DIM), generator=gen, device=dev))
        errs["mirror"] = check_mirror_panels(
            "lite path", cache.Kinv_q, cache.Linv, panels, control=before)
        del before
        kern = kernel_rows_at("lite path", gp, cache, gen, dev)
    X, Y = path.X, path.Y
    del gp, cache, path
    torch.cuda.empty_cache()
    return dict(fit_s=t_fit, build_s=t_build, iters_per_s=LITE_ITERS
                / t_iters, first_iter_s=t_first, flush_s=t_flush,
                resident_gb=resident / 1e9, build_peak_over_gb=build_over
                / 1e9, flush_peak_over_gb=flush_over / 1e9,
                limit_gb=nn4 / 1e9, errs=errs), \
        {"lite": launches, "lite_flush": launches_flush}, kern, (X, Y)


def modes_held(gp_mod, gp, cache, g_t, cache_t, x) -> dict:
    """Checks of the modes path's state that hold at any conditioning.
    K after the refined appends against gram_train_masked of the stored
    points: the build's block is gram_train's and each border gram's, so
    within the sum of the two kernels' tolerances against their plain
    version, 2 (2e-6 + 2e-5 |K|).  The library's pivots of one more append
    at x (models/gp.py _pivot) against their formula in f64 on the same
    f32 operands, within one f32 matvec's rounding (sqrt(N) 2^-24 |A||v|)
    and one rounding of the result: True's u = Kinv k on the True run's
    state; on the refined run's, u0 + Kinv r, with u0 = Kinv k and
    r = k - K u0 computed in f32 by the refined route's own operations (so
    the same bits).  Controls that must miss: K with the last border
    column left unwritten (e_i, as before that append), the refined pivot
    computed with that K, and the raw pivot u0 (the refinement step left
    out) against the refined limit."""
    N, n = gp.capacity, gp.n
    gam = N ** 0.5 * F32_U
    fails, out = [], {}

    def held(key, name, got, want, tol, what):
        try:
            out[key] = check_close(f"modes path: {name}", got, want, tol,
                                   what)
        except AssertionError as e:
            fails.append(str(e))
        e = (got.double() - want).abs()
        out[f"{key}_in_limit"] = float(torch.where(e == 0, 0.0,
                                                   e / tol).max())

    def missed(got, want, tol) -> int:
        return int((~((got.double() - want).abs() <= tol)).sum())

    Kt = gp.kernel.gram_train_masked(gp.x, gp.n).double()
    tol_K = 2 * (2e-6 + 2e-5 * Kt.abs())
    held("K", "K after the appends vs gram_train_masked of the stored "
         "points", cache.K, Kt, tol_K, "2 (2e-6 + 2e-5 |gram_train|)")
    K_ctl = cache.K.clone()
    K_ctl[:, n - 1] = 0.0
    K_ctl[n - 1, n - 1] = 1.0
    out["control_K_missed"] = missed(K_ctl, Kt, tol_K)
    del Kt, tol_K

    k_t = g_t.kernel.gram(x, g_t.x)[0] * g_t.mask
    u_t = gp_mod._pivot(g_t, cache_t, k_t, True)[0]
    Ki = cache_t.Kinv.double()
    U = (Ki @ k_t.double()) * g_t.mask.double()
    held("pivot_true", "True's pivot vs Kinv k in f64 on its f32 operands",
         u_t, U, gam * (Ki.abs() @ k_t.double().abs()) + F32_U * U.abs(),
         "sqrt(N) 2^-24 |Kinv||k| + 2^-24 |u|")
    del Ki, U

    kv = gp.kernel.gram(x, gp.x)[0] * gp.mask
    u0 = gp_mod._pivot(gp, cache, kv, True)[0]
    # the residual in f32, the refined route's own operations on the same
    # operands (so the same bits), then its second step in f64
    r = (kv - cache.K @ u0).double()
    u1 = gp_mod._pivot(gp, cache, kv, "refined")[0]
    u1c = gp_mod._pivot(gp, cache.replace(K=K_ctl), kv, "refined")[0]
    del K_ctl
    Ki = cache.Kinv.double()
    U1 = (u0.double() + Ki @ r) * gp.mask.double()
    tol1 = gam * (Ki.abs_() @ r.abs()) + F32_U * U1.abs()
    del Ki
    held("pivot_refined", "the refined pivot vs u0 + Kinv r in f64, u0 = "
         "Kinv k and r = k - K u0 its f32 operands", u1, U1, tol1,
         "sqrt(N) 2^-24 |Kinv||r| + 2^-24 |u|")
    out["control_pivot_missed"] = missed(u1c, U1, tol1)
    out["control_raw_missed"] = missed(u0, U1, tol1)
    log(f"  in units of their limits: K {out['K_in_limit']:.3g}, True's "
        f"pivot {out['pivot_true_in_limit']:.3g}, the refined pivot "
        f"{out['pivot_refined_in_limit']:.3g}")
    log(f"  controls: K with column {n - 1} unwritten misses its limit in "
        f"{out['control_K_missed']} entries, the refined pivot from that K "
        f"in {out['control_pivot_missed']}, the raw pivot in "
        f"{out['control_raw_missed']} (of {n})")
    if not out["control_K_missed"]:
        fails.append("K with an unwritten border column passes the K check")
    if not out["control_pivot_missed"]:
        fails.append("the refined pivot from a K with an unwritten border "
                     "column passes the pivot check")
    if not out["control_raw_missed"]:
        fails.append("the raw pivot passes the refined pivot check")
    if fails:
        raise AssertionError(f"modes path: {'; '.join(fails)}")
    return out


def modes_path(dev, gen):
    """scripts/update_mode_bench.py's n = 10k (bench.py's workload: the
    main path's data, kernel and capacity 10240, a bf16 mirror): the cache
    built with K for "refined" and plainly for True; MODES_ITERS BO
    iterations in "refined" (the main path's acquisition), then the same
    proposals appended in True.  Held: finite states, the launch counts,
    the checks of modes_held (K after the appends, both modes' pivots
    against their own formula in f64, with controls), and
    MODES_GRAPH_ITERS refined iterations captured through BOStep against
    eager ones, bit for bit.  Printed, not held: both posteriors against
    f64, the refined pivot beside the raw K^-1 k and the solve pivot
    against the f64 pivot, and both K^-1 against a rebuilt one.  At this
    conditioning the matvec pivots lose the f32 posterior mean within a
    few appends in the reference too (ROADMAP.md queue 3), so no limit
    there would be sound."""
    from limbo_tpu_torch.bo.graph import BOStep
    from limbo_tpu_torch.models import gp as gp_mod
    from limbo_tpu_torch.ops import _cuda

    path = MainPath(dev, gen)
    path.fast_update = "refined"
    gp0 = path.fit()
    g_t, _ = clone_state(gp0, gp_mod.QueryCache())
    g_c, _ = clone_state(gp0, gp_mod.QueryCache())
    g_e, _ = clone_state(gp0, gp_mod.QueryCache())
    counts = {}
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    cache = gp_mod.QueryCache.build(gp0, with_K=True, qdtype=torch.bfloat16)
    gp = gp0
    xs = []
    for _ in range(MODES_ITERS):
        x = path.acquire(gp, cache)
        gp, cache = path.append(gp, cache, x)
        xs.append(x)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    counts["modes_refined"] = dict(_cuda.LAUNCHES)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    cache_t = gp_mod.QueryCache.build(g_t, qdtype=torch.bfloat16)
    for x in xs:
        g_t, cache_t = gp_mod.add_sample_cached(
            g_t, cache_t, x, path.objective(x), fast_update=True)
    torch.cuda.synchronize()
    t_raw = time.perf_counter() - t0
    counts["modes_true"] = dict(_cuda.LAUNCHES)
    log(f"modes path: {MODES_ITERS} refined iterations (build with K "
        f"included) {t_ref:.3f} s; the same {MODES_ITERS} proposals "
        f"appended in True mode (build included) {t_raw:.3f} s")
    log(f"  launches, refined: {counts['modes_refined']}; True: "
        f"{counts['modes_true']}")
    per = (STEPS + 2) * MODES_ITERS
    check_counts("modes path (refined)", counts["modes_refined"], {
        "gram": (per, per), "mirror_mm": (per, per), "gram_train": (1, 1),
        "tri_inv_panel": (1, 1), "trimv": (0, 0)})
    check_counts("modes path (True)", counts["modes_true"], {
        "tri_inv_panel": (1, 1), "trimv": (0, 0)})
    check_finite("modes path", L=gp.L, alpha=gp.alpha, Kinv=cache.Kinv,
                 K=cache.K, L_true=g_t.L, Kinv_true=cache_t.Kinv)
    errs = {}
    with uncounted():
        # not held, printed: at this conditioning (l = 1, noise 0.01,
        # cond(K) ~ 1e6) the matvec pivots lose the f32 posterior in both
        # packages (ROADMAP.md queue 3)
        Xq = torch.rand((RESTARTS, DIM), generator=gen, device=dev)
        for name, g in (("refined", gp), ("true", g_t)):
            mu_, var_ = gp_mod.query(g, Xq)
            mu64, var64 = posterior_f64(g, Xq)
            errs[f"{name}_mu"] = float((mu_[:, 0].double()
                                        - mu64[:, 0]).abs().max())
            errs[f"{name}_var"] = float((var_.double() - var64).abs().max())
        log(f"  not held: the posterior against f64 after {MODES_ITERS} "
            f"appends, max |err|: refined mu {errs['refined_mu']:.3e}, var "
            f"{errs['refined_var']:.3e}; True mu {errs['true_mu']:.3e}, var "
            f"{errs['true_var']:.3e}")
        # the pivot of one more append, three ways, against f64
        x = torch.rand((1, DIM), generator=gen, device=dev)
        held = modes_held(gp_mod, gp, cache, g_t, cache_t, x)
        n = gp.n
        mask = gp.mask
        kv = gp.kernel.gram(x, gp.x)[0] * mask
        u_raw, u_ref, u_sol = (gp_mod._pivot(gp, cache, kv, mode)[0]
                               for mode in (True, "refined", False))
        K64 = cache.K[:n, :n].double()
        u64 = torch.cholesky_solve(kv[:n, None].double(),
                                   torch.linalg.cholesky(K64))[:, 0]
        del K64
        pe = {k: float((u[:n].double() - u64).abs().max()
                       / u64.abs().max())
              for k, u in (("raw", u_raw), ("refined", u_ref),
                           ("solve", u_sol))}
        errs["pivot_rel"] = pe
        log(f"  not held: the pivot u = K^-1 k of one more append against "
            f"f64 (the f32 K's), max |err| / max |u|: raw Kinv k "
            f"{pe['raw']:.3e}, refined {pe['refined']:.3e}, two solves on L "
            f"{pe['solve']:.3e}")
        rebuilt = gp_mod.QueryCache.build(gp_mod.recompute(g_t))
        drift = float((cache_t.Kinv - rebuilt.Kinv).abs().max()
                      / rebuilt.Kinv.abs().max())
        drift_ref = float((cache.Kinv - rebuilt.Kinv).abs().max()
                          / rebuilt.Kinv.abs().max())
        del rebuilt
        errs.update(true_drift_rel=drift, refined_drift_rel=drift_ref)
        log(f"  not held: K^-1 after {MODES_ITERS} appends against a "
            f"rebuilt one, max |d| / max |K^-1|: True {drift:.3e}, refined "
            f"{drift_ref:.3e}")
    del gp, cache, g_t, cache_t, gp0
    torch.cuda.empty_cache()

    # captured against eager, bit for bit
    cache_c = gp_mod.QueryCache.build(g_c, with_K=True,
                                      qdtype=torch.bfloat16)
    cache_e = gp_mod.QueryCache.build(g_e, with_K=True,
                                      qdtype=torch.bfloat16)
    gens = [torch.Generator(device=dev).manual_seed(17) for _ in range(2)]
    xs_c = torch.full((MODES_GRAPH_ITERS, DIM), torch.nan, device=dev)
    step = BOStep(g_c, cache_c, lambda model, it: path.propose(model,
                                                                gens[1]),
                  path.objective, gens[1], fast_update="refined",
                  on_sample=lambda it, x, y: xs_c.index_copy_(
                      0, it.reshape(1), x[None, :]))
    del g_c, cache_c
    xs_e = []
    _cuda.reset_launches()
    for _ in range(MODES_GRAPH_ITERS):
        x = path.acquire(g_e, cache_e, gens[0])
        g_e, cache_e = path.append(g_e, cache_e, x)
        xs_e.append(x)
    counts["modes_graph_eager"] = dict(_cuda.LAUNCHES)
    _cuda.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MODES_GRAPH_ITERS):
        step.step()
    torch.cuda.synchronize()
    t_cap = time.perf_counter() - t0
    counts["modes_graph"] = dict(_cuda.LAUNCHES)
    pairs = dict(proposals=(torch.stack(xs_e), xs_c))
    pairs.update({k: (getattr(g_e, k), getattr(step.gp, k))
                  for k in ("x", "y", "L", "alpha", "n_dev")})
    pairs.update({k: (getattr(cache_e, k), getattr(step.cache, k))
                  for k in ("Kinv", "K", "Kinv_q")})
    differ = [k for k, (a, b) in pairs.items() if not same_bits(a, b)]
    if differ:
        raise AssertionError(f"modes path: captured and eager refined runs "
                             f"differ in {differ}")
    if counts["modes_graph"] != counts["modes_graph_eager"]:
        raise AssertionError("modes path: the captured run's launches are "
                             "not the eager run's")
    log(f"  refined, captured == eager, bit for bit, over "
        f"{MODES_GRAPH_ITERS} iterations: {', '.join(pairs)}: ok (captured "
        f"{t_cap:.3f} s with the warm-up and capture; launches "
        f"{counts['modes_graph']})")
    del step, g_e, cache_e
    torch.cuda.empty_cache()
    return dict(refined_s=t_ref, true_s=t_raw, captured_s=t_cap,
                held=held, errs=errs), counts


def gram_rows_check(where: str, kernel, X1, X2) -> float:
    """gram of the run's kernel (its own form and scaling) at (X1, X2)
    against its plain version, at the kernel phase's tolerance."""
    from limbo_tpu_torch.ops import gram_pallas as gp_ops

    form, A, sf2, inv_l = kernel._fused_train_args(X1)
    B = kernel._fused_train_args(X2)[1]
    if not gp_ops.use_pallas(A, B):
        raise AssertionError(f"{where}: gram ({A.shape[0]}x{B.shape[0]}) is "
                             "under the kernel's size rule")
    kk = gp_ops.gram_pallas(A, B, sf2, inv_l, form)
    p = gp_ops.gram_plain(A, B, sf2, inv_l, form)
    return check_close(f"{where}: gram {form} ({A.shape[0]}x{B.shape[0]})",
                       kk, p, 2e-6 + 2e-5 * p.abs(), "2e-6 + 2e-5|plain|")


def nlml_abs_terms(sp, spgp) -> float:
    """The sum of the absolute values of the FITC NLML's terms in f64 (the
    scale of its f32 accumulation error)."""
    from limbo_tpu_torch.means.means import prepare_mean

    k64, X, Y = cast(sp.kernel, torch.float64), sp.x.double(), sp.y.double()
    mask = sp.mask.double()
    mean = prepare_mean(cast(sp.mean, torch.float64), Y, mask)
    Yc = (Y - mean(X)) * mask[:, None]
    _, La, _, lam, ys, beta = spgp._fitc_terms(k64, sp.xb.double(), X, Yc,
                                               mask, k64.noise)
    p = Y.shape[1]
    return float(0.5 * (torch.sum(ys * ys) + torch.sum(beta * beta))
                 + 0.5 * p * (torch.sum(torch.log(lam).abs() * mask)
                              + 2.0 * torch.sum(torch.log(
                                  torch.diagonal(La)).abs()))
                 + 0.5 * sp.n * p * math.log(2 * math.pi))


def cast(module, dtype):
    """A copy of a kernel or mean module in another dtype (Module.to casts
    in place)."""
    import copy

    return copy.deepcopy(module).to(dtype)


def perturbed_f64(fn, inputs: dict, rel: float, dtype=torch.float64,
                  seed: int = 2):
    """fn(**inputs) in ``dtype`` with every input multiplied by 1 + rel e,
    e uniform in [-1, 1] from a fixed seed.  In f64 with rel = 2^-24: the
    move of the function under one f32 rounding of its inputs.  In f32 with
    rel = 2^-23 (one f32 step): also the f32 evaluation's own rounding,
    which a sum over many terms (an NLML and its gradient over n points)
    carries beyond that move.  ``seed`` draws another e."""
    g = torch.Generator().manual_seed(seed)
    moved = {k: (v.double() * (1.0 + rel * (torch.rand(
        v.shape, generator=g, dtype=torch.float64) * 2 - 1).to(v.device))
        ).to(dtype) for k, v in inputs.items()}
    return fn(**moved)


def spgp_value_grad(sp, spgp, xb, p, x, y):
    """The FITC NLML of ``sp``'s model (kernel and mean cast to p's dtype)
    at (xb, p, x, y), and its gradient in (xb, p) flattened."""
    xb, p = (t.detach().requires_grad_(True) for t in (xb, p))
    val = spgp.neg_log_marginal_likelihood(
        cast(sp.kernel, p.dtype).with_params(p), cast(sp.mean, p.dtype), xb,
        x, y, sp.n)
    g1, g2 = torch.autograd.grad(val, (xb, p))
    return val.detach(), torch.cat([g1.reshape(-1), g2])


def spgp_readings(sp, spgp, Xq, v32, g32) -> dict:
    """The f32 SPGP's NLML ``v32``, its gradient ``g32`` in (xb, kernel
    parameters) and its query at Xq against the same functions in f64 on
    the same inputs, each beside its limit, and for the gradient and the
    query a control on inputs moved by 2^-9 that must miss it.  Limits, in
    BO_SLACK times a scale: the NLML's move under one f32 rounding of the
    inputs plus its f32 accumulation over the n points (sqrt(n) 2^-24
    sum|terms|); for the gradient the larger of its move under one f32
    rounding and its accumulation over the n points at its own scale
    (sqrt(n) 2^-24 max|g|); for the query the larger of its move under one
    f32 rounding (in f64) and under one f32 step (in f32).  Readings of
    several data sets: scripts/torch_spgp_spread.py."""
    n = sp.n
    inputs = dict(xb=sp.xb, p=sp.kernel.params, x=sp.x, y=sp.y)

    def value_grad(xb, p, x, y):
        return spgp_value_grad(sp, spgp, xb, p, x, y)

    v64, g64 = value_grad(**{k: t.double() for k, t in inputs.items()})
    vs, gs = perturbed_f64(value_grad, inputs, F32_U)
    r = dict(n=n, m=sp.m, nlml_err=float((v32.double() - v64).abs()),
             nlml_sens=float((vs - v64).abs()),
             nlml_acc=n ** 0.5 * F32_U * nlml_abs_terms(sp, spgp),
             grad_err=float((g32.double() - g64).abs().max()),
             grad_sens=float((gs - g64).abs().max()),
             grad_max=float(g64.abs().max()))
    r["nlml_tol"] = BO_SLACK * r["nlml_sens"] + r["nlml_acc"]
    r["grad_acc"] = n ** 0.5 * F32_U * r["grad_max"]
    r["grad_tol"] = BO_SLACK * max(r["grad_sens"], r["grad_acc"])
    r["grad_control"] = float((perturbed_f64(
        value_grad, inputs, 2.0 ** -9, torch.float32)[1] - g64).abs().max())

    def q(xb, p, x, y, q):
        dt = p.dtype
        s = sp.replace(kernel=cast(sp.kernel, dt).with_params(p),
                       mean=cast(sp.mean, dt), xb=xb, x=x, y=y)
        mu_, var_ = spgp.query(s, q)
        return torch.cat([mu_[:, 0], var_])

    qin = dict(inputs, q=Xq)
    mv = torch.cat([t.reshape(-1) for t in spgp.query(sp, Xq)])
    mv64 = q(**{k: t.double() for k, t in qin.items()})
    r["query_err"] = float((mv.double() - mv64).abs().max())
    r["query_sens"] = [
        float((perturbed_f64(q, qin, F32_U) - mv64).abs().max()),
        float((perturbed_f64(q, qin, 2 * F32_U, torch.float32)
               - mv).abs().max())]
    r["query_tol"] = BO_SLACK * max(r["query_sens"])
    r["query_control"] = float((perturbed_f64(
        q, qin, 2.0 ** -9, torch.float32) - mv64).abs().max())
    return r


def hold_spgp(r: dict) -> None:
    """Log spgp_readings' numbers and raise where one misses its limit or a
    control passes."""
    for name, what in (("nlml", f"{BO_SLACK} x its move under one f32 "
                        f"rounding ({r['nlml_sens']:.3e}) + sqrt(n) 2^-24 "
                        f"sum|terms| ({r['nlml_acc']:.3e})"),
                       ("grad", f"{BO_SLACK} x the larger of its move under "
                        f"one f32 rounding ({r['grad_sens']:.3e}) and sqrt(n)"
                        f" 2^-24 max|g| ({r['grad_acc']:.3e})"),
                       ("query", f"{BO_SLACK} x the larger of its move under "
                        f"one f32 rounding (f64: {r['query_sens'][0]:.3e}) "
                        f"and under one f32 step (f32: "
                        f"{r['query_sens'][1]:.3e})")):
        e, tol = r[f"{name}_err"], r[f"{name}_tol"]
        ok = e <= tol
        log(f"  spgp {name} vs f64: max |err| {e:.3e}, {e / tol:.3g} of the "
            f"limit {tol:.3e} = {what}: {'ok' if ok else 'over'}")
        if not ok:
            raise AssertionError(f"spgp (c): the {name} misses its limit")
        if name != "nlml":
            c = r[f"{name}_control"]
            log(f"  control: the f32 {name} on inputs moved by 2^-9 is off "
                f"by {c:.3e} ({c / tol:.3g} of the limit)")
            if not c > tol:
                raise AssertionError(f"spgp (c): a {name} from inputs moved "
                                     "by 2^-9 passes its check")


def models_path(dev, gen, data):
    """The other model families on the card.  (a) iterative.fit on the lite
    path's n = 32,768 data (capacity 33,280, block 2048, tol 1e-5, maxiter
    256), a query with variance at 64 points, its mean against the exact
    f64 posterior within the identity mu - mu_exact = (K^-1 k)^T r,
    r = K alpha_cg - y in f64; then add_sample + refit.  (b) BOptimizer(model_type="iterative") on
    -Hartmann6, 4096 init points (capacity 5120), MODELS_B_ITERS
    iterations.  (c) SPGP on the same data at m = ceil(0.1 n) = 3277: the
    NLML and its gradient and the query against the same functions in f64,
    within BO_SLACK times their move under one f32 rounding of the inputs;
    SPGPHpOpt cut to Rprop(10).  (d) BOptimizer(model_type="spgp",
    hp_opt=SPGPHpOpt(), hp_period=10) at m = 16, MODELS_D_ITERS
    iterations.  (e) BOptimizer(max_model_points=200) with 256 init points,
    MODELS_E_ITERS iterations.  (f) MultiGP.fit, 2 outputs at n = 4096, bit
    for bit against two independent gp.fits, then ParallelLFOpt cut to
    KernelLFOpt(Rprop(5)).  Each BO run checks best_value == max(observed)
    and a finite model; each kernel is held against its plain version at
    the shapes the subpath gave it."""
    from limbo_tpu_torch.bo import BOptimizer, MaxIterations, RandomSampling
    from limbo_tpu_torch.kernels import SquaredExpARD
    from limbo_tpu_torch.kernels.base import JITTER
    from limbo_tpu_torch.means import DataMean, NullMean
    from limbo_tpu_torch.models import (gp as gp_mod, iterative, multi_gp,
                                        spgp)
    from limbo_tpu_torch.models.hp_opt import KernelLFOpt
    from limbo_tpu_torch.opt import Rprop
    from limbo_tpu_torch.ops import _cuda

    X, Y = data
    n, d = X.shape
    out, counts, err = {}, {}, 0.0

    def kern():
        k = SquaredExpARD.create(dim=d, noise=HP_NOISE, device=dev)
        return k.replace(log_ell=torch.full((d,), math.log(HP_ELL),
                                            device=dev))

    # (a) the CG GP
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    it = iterative.fit(kern(), DataMean.create(device=dev), X, Y,
                       capacity=LITE_CAPACITY, block=2048, cg_tol=1e-5,
                       cg_maxiter=256, device=dev)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    Xq = torch.rand((RESTARTS, d), generator=gen, device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        mu, var = iterative.query(it, Xq)
    torch.cuda.synchronize()
    t_q = time.perf_counter() - t0
    iters_fit, res_fit = int(it.cg_iters), float(it.cg_residual.max())
    with uncounted():
        # the identity in f64: with r = K alpha - y_c, mu_cg - mu_exact =
        # (K^-1 k)^T r; the port's f32 query adds its own rounding
        k64 = cast(it.kernel, torch.float64)
        X64, a64 = X.double(), it.alpha[:n].double()
        yc64 = (it.y[:n] - it.mean(it.x[:n])).double()
        K64 = k64.gram(X64, X64)
        K64.diagonal().add_(float(it.kernel.noise) + JITTER)
        r64 = K64 @ a64 - yc64
        Lc = torch.linalg.cholesky(K64)
        del K64
        ks64 = k64.gram(Xq.double(), X64)
        mu64 = ks64 @ torch.cholesky_solve(yc64, Lc)
        dmu = (torch.cholesky_solve(ks64.T, Lc).T @ r64)
        del Lc
        mu_cg = (mu - it.mean(Xq)).double()
        s = float(((X * torch.exp(-it.kernel.log_ell)) ** 2).sum(1).max())
        tol = F32_U * ((n ** 0.5 + 8 * s) * (ks64.abs() @ a64.abs())
                       + 2 * mu.abs().double())
        e_id = check_close("iterative: mu - mu_exact vs (K^-1 k)^T r",
                           mu_cg - mu64, dmu, tol,
                           "2^-24 ((sqrt(n) + 8 max|x/l|^2) (|ks| @ "
                           "|alpha|) + 2 |mu|)")
        log(f"  |mu - mu_exact| up to {float((mu_cg - mu64).abs().max()):.3e}"
            f", of which the CG residual's share (K^-1 k)^T r up to "
            f"{float(dmu.abs().max()):.3e}; var in [{float(var.min()):.3e}, "
            f"{float(var.max()):.3e}]")
        err = max(err, gram_rows_check("iterative (a)", it.kernel,
                                       X[:2048], it.x),
                  gram_rows_check("iterative (a)", it.kernel, Xq, it.x))
    xn = torch.rand((d,), generator=gen, device=dev)
    it = iterative.add_sample(it, xn, torch.sin(3.0 * xn.sum())[None])
    t0 = time.perf_counter()
    it = iterative.refit(it)
    torch.cuda.synchronize()
    t_refit = time.perf_counter() - t0
    counts["models_a"] = dict(_cuda.LAUNCHES)
    check_finite("iterative (a)", alpha=it.alpha, mu=mu, var=var)
    nb = -(-it.capacity // 2048)
    check_counts("iterative (a)", counts["models_a"], {
        "gram": (nb * (iters_fit + int(it.cg_iters)) + 1, None)})
    log(f"models path (a) iterative: fit {t_fit:.3f} s ({iters_fit} CG "
        f"iterations, max residual {res_fit:.3e} of tol 1e-5 |b|), query "
        f"with variance at {RESTARTS} points {t_q:.3f} s, refit after an "
        f"append {t_refit:.3f} s ({int(it.cg_iters)} iterations, max "
        f"residual {float(it.cg_residual.max()):.3e}); launches "
        f"{counts['models_a']}")
    out["a"] = dict(fit_s=t_fit, query_s=t_q, refit_s=t_refit,
                    cg_iters=[iters_fit, int(it.cg_iters)],
                    cg_residual=[res_fit, float(it.cg_residual.max())],
                    identity_err=e_id)
    del it
    torch.cuda.empty_cache()

    # (b) BOptimizer over the CG GP
    bo = BOptimizer(model_type="iterative", init=RandomSampling(BO_C_INIT),
                    stop=(MaxIterations(MODELS_B_ITERS),))
    state, counts["models_b"], out["b"] = bo_run(
        "models b, iterative", bo, dev, gen, MODELS_B_ITERS)
    check_counts("models path (b)", counts["models_b"],
                 {"gram": (MODELS_B_ITERS, None)})
    with uncounted():
        err = max(err, gram_rows_check("iterative (b)", state.gp.kernel,
                                       state.gp.x[:2048], state.gp.x))
    out["b"]["cg_iters_last_refit"] = int(state.gp.cg_iters)
    del state, bo

    # (c) SPGP at m = ceil(0.1 n)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    sp = spgp.fit(kern(), DataMean.create(device=dev), X, Y,
                  generator=gen, device=dev)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    m = sp.m

    t0 = time.perf_counter()
    v, g32 = spgp_value_grad(sp, spgp, sp.xb, sp.kernel.params, sp.x, sp.y)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    with uncounted():
        rd = spgp_readings(sp, spgp, Xq, v, g32)
        hold_spgp(rd)
        err = max(err, gram_rows_check("spgp (c)", sp.kernel, sp.x, sp.xb),
                  gram_rows_check("spgp (c)", sp.kernel, sp.xb, sp.xb))
    v0 = float(v)
    t0 = time.perf_counter()
    sp2 = spgp.SPGPHpOpt(optimizer=Rprop(iterations=10))(sp, gen)
    torch.cuda.synchronize()
    t_hp = time.perf_counter() - t0
    v1 = float(spgp.neg_log_marginal_likelihood(sp2.kernel, sp2.mean,
                                                sp2.xb, sp2.x, sp2.y, sp2.n))
    counts["models_c"] = dict(_cuda.LAUNCHES)
    log(f"models path (c) spgp: n {n}, m {m}: fit {t_fit:.3f} s, one f32 "
        f"NLML + gradient {t_eval:.3f} s, SPGPHpOpt(Rprop(10)) {t_hp:.3f} "
        f"s, NLML {v0:.4f} -> {v1:.4f}; launches {counts['models_c']}")
    if not v1 <= v0:
        raise AssertionError("spgp (c): the NLML rose during SPGPHpOpt")
    check_finite("spgp (c)", xb=sp2.xb, p=sp2.kernel.params)
    check_counts("spgp (c)", counts["models_c"], {"gram": (2 * 12, None)})
    out["c"] = dict(fit_s=t_fit, eval_s=t_eval, hp_s=t_hp, m=m,
                    nlml=[v0, v1], errs=rd)
    del sp, sp2, v, g32
    torch.cuda.empty_cache()

    # (d) BOptimizer over SPGP, (e) capped at max_model_points
    bo = BOptimizer(model_type="spgp", hp_opt=spgp.SPGPHpOpt(), hp_period=10,
                    stop=(MaxIterations(MODELS_D_ITERS),))
    state, counts["models_d"], out["d"] = bo_run(
        "models d, spgp m = 16", bo, dev, gen, MODELS_D_ITERS)
    del state, bo
    bo = BOptimizer(max_model_points=200, init=RandomSampling(256),
                    stop=(MaxIterations(MODELS_E_ITERS),))
    state, counts["models_e"], out["e"] = bo_run(
        "models e, max_model_points = 200", bo, dev, gen, MODELS_E_ITERS,
        n_final=200)
    check_counts("models path (e)", counts["models_e"], {
        "gram": (MODELS_E_ITERS, None), "gram_train": (MODELS_E_ITERS, None)})
    with uncounted():
        err = max(err, gram_rows_check(
            "sparse (e)", state.gp.kernel, torch.rand(
                (SWEEP, BO_DIM), generator=gen, device=dev), state.gp.x))
    del state, bo

    # (f) MultiGP
    Xm, Ym = X[:4096], torch.cat([Y[:4096], torch.cos(3.0 * X[:4096].sum(
        1, keepdim=True))], dim=1)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    mg = multi_gp.fit(kern(), DataMean.create(dim_out=2, device=dev), Xm, Ym,
                      device=dev)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    with uncounted():
        for j, g in enumerate(mg.gps):
            f = gp_mod.fit(kern(), NullMean(), Xm, g.y[:Xm.shape[0]],
                           capacity=mg.capacity, device=dev)
            if not (same_bits(f.L, g.L) and same_bits(f.alpha, g.alpha)):
                raise AssertionError(f"multi (f): output {j} is not the "
                                     f"independent fit's bits")
    lml0 = [float(gp_mod.log_lik(g)) for g in mg.gps]
    t0 = time.perf_counter()
    mg2 = multi_gp.ParallelLFOpt(KernelLFOpt(Rprop(iterations=5)))(mg, gen)
    torch.cuda.synchronize()
    t_hp = time.perf_counter() - t0
    lml1 = [float(gp_mod.log_lik(g)) for g in mg2.gps]
    counts["models_f"] = dict(_cuda.LAUNCHES)
    log(f"models path (f) MultiGP: fit 2 outputs at n 4096 {t_fit:.3f} s, "
        f"each output bit for bit the independent fit: ok; ParallelLFOpt("
        f"KernelLFOpt(Rprop(5))) {t_hp:.3f} s, LML {lml0} -> {lml1}; "
        f"launches {counts['models_f']}")
    check_finite("multi (f)", **model_fields(mg2))
    if not all(b >= a for a, b in zip(lml0, lml1)):
        raise AssertionError("multi (f): an output's LML fell during hp-opt")
    check_counts("multi (f)", counts["models_f"], {
        "gram_train": (2 + 2 * 6, None), "tri_inv_panel": (2 * 5, None)})
    out["f"] = dict(fit_s=t_fit, hp_s=t_hp, lml=[lml0, lml1])
    out["kernel_err"] = err
    del mg, mg2
    torch.cuda.empty_cache()
    return out, counts


def mop2(x):
    """mop2 (examples/experimental/multi.py, maximized as -f) on [0, 1]^d
    mapped to [-2, 2]^d, from a numpy array to a (2,) one in f64."""
    x = np.asarray(x, dtype=np.float64) * 4.0 - 2.0
    n = len(x)
    f1 = 1.0 - np.exp(-np.sum((x - 1.0 / np.sqrt(n)) ** 2))
    f2 = 1.0 - np.exp(-np.sum((x + 1.0 / np.sqrt(n)) ** 2))
    return np.array([-f1, -f2])


def zdt2(x):
    """zdt2 (examples/experimental/multi.py, maximized as -f)."""
    x = np.asarray(x, dtype=np.float64)
    f1 = x[0]
    g = 1.0 + 9.0 * np.mean(x[1:]) if len(x) > 1 else 1.0
    return np.array([-f1, -g * (1.0 - (f1 / g) ** 2)])


def dtlz2_3(x):
    """DTLZ2 with 3 objectives (examples/experimental/multi3.py,
    maximized as -f)."""
    x = np.asarray(x, dtype=np.float64)
    g = np.sum((x[2:] - 0.5) ** 2)
    c1, s1 = np.cos(0.5 * np.pi * x[0]), np.sin(0.5 * np.pi * x[0])
    c2, s2 = np.cos(0.5 * np.pi * x[1]), np.sin(0.5 * np.pi * x[1])
    return np.array([-(1 + g) * c1 * c2, -(1 + g) * c1 * s2,
                     -(1 + g) * s1])


class _LastStep:
    """A stats writer that keeps what the loop's last step saw: its model,
    the observed front before the step's points, and the points."""

    def __init__(self, q: int = 1):
        self.q = q

    def __call__(self, loop, state=None):
        self.model = loop.model
        self.X, self.Y = np.stack(loop.X), np.stack(loop.Y)
        self.x_new = self.X[-self.q:]


class _TimedNsga2:
    """Nsga2 with each call's seconds (to a synchronize) and launches."""

    def __init__(self, ea):
        self.ea, self.calls = ea, []

    def __call__(self, *args, **kwargs):
        from limbo_tpu_torch.ops import _cuda

        before = dict(_cuda.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.ea(*args, **kwargs)
        torch.cuda.synchronize()
        self.calls.append(dict(
            s=time.perf_counter() - t0,
            launches={k: v - before[k] for k, v in _cuda.LAUNCHES.items()
                      if v != before[k]}))
        return out


def mo_front_checks(where: str, f, Xp, Yp, ref, n_init: int) -> dict:
    """A loop's returned front and observations: the front non-dominated
    by the port's mask and by the native filter, the two masks the same
    over every observation, the front the observations' front, the 2-D
    hypervolume against the native sweep to 1e-12 relative, and the final
    front's hypervolume above the init design's."""
    from limbo_tpu_torch import native
    from limbo_tpu_torch.ops import pareto

    Y = np.stack(f.obs)
    ref64 = np.asarray(ref, dtype=np.float64)
    nd_port = pareto.non_dominated_mask(torch.from_numpy(Y)).numpy()
    nd_host = native.filter_nondominated_host(Y)
    if not np.array_equal(nd_port, nd_host):
        raise AssertionError(f"{where}: the port's front mask and the native "
                             "filter disagree")
    if not (pareto.non_dominated_mask(torch.from_numpy(Yp)).all()
            and native.filter_nondominated_host(Yp).all()):
        raise AssertionError(f"{where}: the returned front is dominated")
    if sorted(map(tuple, Yp)) != sorted(map(tuple, Y[nd_host])):
        raise AssertionError(f"{where}: the returned front is not the "
                             "observations' front")
    hv = native.hv_host(Yp, ref64)
    hv0 = native.hv_host(Y[:n_init][native.filter_nondominated_host(
        Y[:n_init])], ref64)
    out = dict(front=len(Yp), hv=hv, hv_init=hv0)
    if Y.shape[1] == 2:
        hv2 = float(pareto.hypervolume_2d(torch.from_numpy(Yp),
                                          torch.from_numpy(ref64)))
        out["hv_rel_err"] = abs(hv2 - hv) / hv
        if not out["hv_rel_err"] <= 1e-12:
            raise AssertionError(f"{where}: hypervolume_2d {hv2} against "
                                 f"hv_host {hv}")
    if not hv > hv0:
        raise AssertionError(f"{where}: the final front's hypervolume {hv} "
                             f"is not above the init design's {hv0}")
    log(f"  front of {len(Yp)} non-dominated (port mask == native filter "
        f"over {len(Y)} observations), hypervolume {hv:.6f} against the "
        f"init design's {hv0:.6f}"
        + (f", hypervolume_2d rel. err {out['hv_rel_err']:.2e} (limit "
           f"1e-12)" if "hv_rel_err" in out else ""))
    return out


def mo_last_step_ehvi(where: str, last: _LastStep, ref, host) -> float:
    """The last step's EHVI at its point, recomputed in f64 by the port
    (ops.ehvi.ehvi_max on the step's model and front) against the native
    exact EHVI (``host``), to 1e-10 relative."""
    from limbo_tpu_torch import native
    from limbo_tpu_torch.models import multi_gp
    from limbo_tpu_torch.ops.ehvi import ehvi_max

    prev = last.Y[:-last.q]
    front = prev[native.filter_nondominated_host(prev)]
    if len(front) > 64:
        raise AssertionError(f"{where}: front of {len(front)} > 64 rows")
    m = last.model
    with torch.no_grad():
        mu, var = multi_gp.query(m, torch.as_tensor(
            last.x_new, dtype=m.gps[0].x.dtype, device=m.gps[0].x.device))
        mu, sigma = mu.double(), torch.sqrt(torch.clamp(var.double(),
                                                        min=1e-20))
        got = float(ehvi_max(mu, sigma, torch.from_numpy(front).to(mu),
                             torch.tensor(ref, dtype=torch.float64,
                                          device=mu.device))[0])
    want = float(host(mu.cpu().numpy(), sigma.cpu().numpy(), front,
                      np.asarray(ref, dtype=np.float64))[0])
    rel = abs(got - want) / abs(want)
    log(f"  last step's EHVI at its point {got:.10e}, native {want:.10e}: "
        f"rel. err {rel:.2e} (limit 1e-10)")
    if not (want > 0 and rel <= 1e-10):
        raise AssertionError(f"{where}: EHVI {got} against native {want}")
    return rel


def mo_run(name: str, loop, f, dim: int, gen, iters: int, ref,
           setup_clock: bool = True):
    """One loop's optimize on the card with the launch counts set to 0 just
    before it and read just after; returns (front, launches, numbers).
    Set-up: to the first stop check where the loop has one, else to the
    end of the init design's evaluations."""
    from limbo_tpu_torch.ops import _cuda

    rec = _Recorded(f)
    clock = _SetupClock()
    if setup_clock:
        loop.stop = loop.stop + (clock,)
    n_init = loop.init.count
    marks = []

    def timed(x):
        y = rec(x)
        if len(rec.ys) == n_init:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        return y

    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    Xp, Yp = loop.optimize(timed, dim, generator=gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = dict(_cuda.LAUNCHES)
    t_setup = (clock.t if setup_clock else marks[0]) - t0
    loop_s = t1 - t0 - t_setup
    q = getattr(loop, "q", 1)
    log(f"mo path ({name}): set-up {t_setup:.3f} s ({n_init} init points), "
        f"{iters} iterations {loop_s:.3f} s = {iters / loop_s:.3f} iters/s; "
        f"launches {({k: v for k, v in launches.items() if v})}")
    if len(rec.ys) != n_init + iters * q:
        raise AssertionError(f"mo path ({name}): {len(rec.ys)} evaluations")
    X = np.stack(rec.xs)
    if not bool(((X >= 0) & (X <= 1)).all()):
        raise AssertionError(f"mo path ({name}): a sample outside the box")
    out = mo_front_checks(f"mo path ({name})", rec, Xp, Yp, ref, n_init)
    out.update(setup_s=t_setup, loop_s=loop_s, iters=iters,
               iters_per_s=iters / loop_s)
    return rec, launches, out


def mo_path(dev, gen):
    """Multi-objective and batch BO through their entry points (slice 10).
    (a) Ehvi(ref=(-1.1, -1.1)) on mop2, d = 2, MO_A_ITERS iterations;
    (b) Nsbo(n_objs=2) on mop2, MO_B_ITERS; (c) Parego(n_objs=2,
    iterations=MO_C_ITERS) on zdt2, d = 3; (d) Ehvi(q=2, gh_nodes=12) on
    mop2, MO_D_ITERS; (e) Ehvi(ref=(-1.2,)*3) on DTLZ2 with 3 objectives,
    d = 3, MO_E_ITERS: the examples' own configurations
    (examples/experimental/{multi,multi_batch,multi3}.py) in the
    reference's f64, which launch no kernel.  (f) BOptimizer.optimize_batch(
    q=4, restarts=16, steps=30, QEI(128)) on -Hartmann6 at bo path (c)'s
    width: SquaredExpARD, MO_F_INIT init points (capacity 5120), f32,
    MO_F_ROUNDS rounds; (g) Ehvi in f32 on mop2 at d = 6 with MO_G_INIT init
    points (capacity 4160), MO_G_ITERS iterations, a MultiGP refit each.

    Each run: the front non-dominated by the port's mask and the native
    filter (which agree over every observation), hypervolume_2d against
    hv_host to 1e-12, the final front's hypervolume above the init
    design's; in (a) and (e) the last step's EHVI at its point in f64
    against the native exact EHVI to 1e-10; in (d) the chosen batch's
    q-EHVI at least its best singleton's and at most their sum; in (f) and
    (g) the best observations the stored ones, a finite model, its
    posterior against f64 (check_posterior_exact) and each launched
    kernel against its plain version on the run's state."""
    from limbo_tpu_torch import native
    from limbo_tpu_torch.acqui.qei import QEI, joint_posterior_multi
    from limbo_tpu_torch.bo import BOptimizer, MaxIterations, RandomSampling
    from limbo_tpu_torch.bo.multi import Ehvi, Nsbo, Parego
    from limbo_tpu_torch.kernels import SquaredExpARD
    from limbo_tpu_torch.ops import _cuda
    from limbo_tpu_torch.ops import gram_pallas as gp_ops
    from limbo_tpu_torch.ops.ehvi import qehvi_exact_max
    from limbo_tpu_torch.opt import Nsga2

    out, counts, err = {}, {}, 0.0
    f64 = dict(device=dev, dtype=torch.float64)

    # (a) EHVI on mop2
    last = _LastStep()
    loop = Ehvi(ref=(-1.1, -1.1), stop=(MaxIterations(MO_A_ITERS),),
                stats_enabled=True, stats=(last,), **f64)
    _, counts["mo_a"], out["a"] = mo_run("a, Ehvi mop2", loop, mop2, 2, gen,
                                         MO_A_ITERS, (-1.1, -1.1))
    out["a"]["ehvi_rel_err"] = mo_last_step_ehvi(
        "mo path (a)", last, (-1.1, -1.1), native.ehvi2d_host)

    # (b) NSBO on mop2, each NSGA-II call timed
    ea = _TimedNsga2(Nsga2(pop_size=64, generations=30))
    loop = Nsbo(n_objs=2, stop=(MaxIterations(MO_B_ITERS),), nsga2=ea, **f64)
    _, counts["mo_b"], out["b"] = mo_run("b, Nsbo mop2", loop, mop2, 2, gen,
                                         MO_B_ITERS, (-1.1, -1.1))
    secs = [c["s"] for c in ea.calls]
    log(f"  NSGA-II (64 x 30 generations): {len(secs)} calls, "
        f"{min(secs):.3f} to {max(secs):.3f} s, launches "
        f"{[c['launches'] for c in ea.calls]}")
    if len(secs) != MO_B_ITERS:
        raise AssertionError("mo path (b): NSGA-II calls != iterations")
    out["b"]["nsga2_s"] = secs
    out["b"]["nsga2_launches"] = [c["launches"] for c in ea.calls]

    # (c) ParEGO on zdt2
    loop = Parego(n_objs=2, iterations=MO_C_ITERS, **f64)
    # zdt2's second objective reaches -10 at d = 3: a reference point below
    # both objectives' ranges
    _, counts["mo_c"], out["c"] = mo_run("c, Parego zdt2", loop, zdt2, 3,
                                         gen, MO_C_ITERS, (-1.1, -10.1),
                                         setup_clock=False)

    # (d) exact q-EHVI, q = 2, on mop2
    last = _LastStep(q=2)
    loop = Ehvi(ref=(-1.1, -1.1), q=2, gh_nodes=12,
                stop=(MaxIterations(MO_D_ITERS),), stats_enabled=True,
                stats=(last,), **f64)
    _, counts["mo_d"], out["d"] = mo_run("d, Ehvi q = 2 mop2", loop, mop2, 2,
                                         gen, MO_D_ITERS, (-1.1, -1.1))
    prev = last.Y[:-2]
    front = torch.from_numpy(prev[native.filter_nondominated_host(prev)]).to(
        dev)
    refd = torch.tensor((-1.1, -1.1), **f64)
    with torch.no_grad():
        mu, cov = joint_posterior_multi(last.model, torch.from_numpy(
            last.x_new).to(dev))
        v = float(qehvi_exact_max(mu, cov, front, refd, gh_nodes=12))
        singles = [float(qehvi_exact_max(mu[j:j + 1], cov[:, j:j + 1,
                                                          j:j + 1],
                                         front, refd, gh_nodes=12))
                   for j in range(2)]
    slack = 1e-9 * sum(singles)
    log(f"  the chosen batch's q-EHVI {v:.6e}: singletons {singles}, at "
        f"least the best and at most their sum (slack {slack:.1e})")
    if not (max(singles) - slack <= v <= sum(singles) + slack):
        raise AssertionError("mo path (d): q-EHVI outside [max, sum] of its "
                             "singletons")
    out["d"]["qehvi"] = [v, singles]

    # (e) exact 3-D EHVI on DTLZ2
    last = _LastStep()
    ref3 = (-1.2, -1.2, -1.2)
    loop = Ehvi(ref=ref3, stop=(MaxIterations(MO_E_ITERS),),
                stats_enabled=True, stats=(last,), **f64)
    _, counts["mo_e"], out["e"] = mo_run("e, Ehvi DTLZ2 3 objectives", loop,
                                         dtlz2_3, 3, gen, MO_E_ITERS, ref3)
    out["e"]["ehvi_rel_err"] = mo_last_step_ehvi(
        "mo path (e)", last, ref3, native.ehvi3d_host)
    for k in "abcde":
        check_counts(f"mo path ({k})", counts[f"mo_{k}"],
                     {x: (0, 0) for x in _cuda.LAUNCHES})

    # (f) batch BO: q-EI over -Hartmann6 at 4096 points, f32
    bo = BOptimizer(kernel=SquaredExpARD.create(dim=BO_DIM, device=dev),
                    init=RandomSampling(MO_F_INIT),
                    stop=(MaxIterations(MO_F_ROUNDS),), device=dev)
    rec = _Recorded(hartmann6)
    clock = _SetupClock()
    bo.stop = bo.stop + (clock,)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    state = bo.optimize_batch(rec, BO_DIM, q=4, generator=gen,
                              qei=QEI(n_samples=128), restarts=16, steps=30)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts["mo_f"] = dict(_cuda.LAUNCHES)
    setup, loop_s = clock.t - t0, t1 - clock.t
    gp = state.gp
    log(f"mo path (f, optimize_batch q = 4): set-up {setup:.3f} s "
        f"({MO_F_INIT} init points, capacity {gp.capacity}), {MO_F_ROUNDS} "
        f"rounds {loop_s:.3f} s = {MO_F_ROUNDS / loop_s:.3f} rounds/s; best "
        f"{state.best_value:.6f}; launches "
        f"{({k: v for k, v in counts['mo_f'].items() if v})}")
    n = MO_F_INIT + 4 * MO_F_ROUNDS
    if gp.n != n or len(rec.ys) != n or state.iteration != MO_F_ROUNDS:
        raise AssertionError(f"mo path (f): {gp.n} samples, {len(rec.ys)} "
                             "evaluations")
    best = float(torch.tensor(max(rec.ys), dtype=torch.float32))
    if state.best_value != best:
        raise AssertionError(f"mo path (f): best_value {state.best_value} "
                             f"!= max(observed) {best}")
    X = torch.stack([torch.from_numpy(x) for x in rec.xs])
    if not (bool(((X >= 0) & (X <= 1)).all())
            and bool(((gp.x[:n] >= 0) & (gp.x[:n] <= 1)).all())):
        raise AssertionError("mo path (f): a sample outside [0, 1]^6")
    check_finite("mo path (f)", L=gp.L, alpha=gp.alpha)
    check_counts("mo path (f)", counts["mo_f"],
                 {"gram": (30 * MO_F_ROUNDS, None)})
    out["f"] = dict(setup_s=setup, loop_s=loop_s, rounds=MO_F_ROUNDS,
                    rounds_per_s=MO_F_ROUNDS / loop_s, best=state.best_value,
                    launches_per_round={k: v / MO_F_ROUNDS for k, v in
                                        counts["mo_f"].items() if v})
    with uncounted():
        err = max(err, bo_kernel_checks("mo path (f)", gp, None, gen, dev))
        out["f"]["errs"] = check_posterior_exact(gp, torch.rand(
            (RESTARTS, BO_DIM), generator=gen, device=dev),
            control_rel=MO_CONTROL_REL)
    del state, gp, bo
    torch.cuda.empty_cache()

    # (g) EHVI in f32 at 4096 points, d = 6
    loop = Ehvi(ref=(-1.1, -1.1), init=RandomSampling(MO_G_INIT),
                stop=(MaxIterations(MO_G_ITERS),), dtype=torch.float32,
                device=dev)
    rec, counts["mo_g"], out["g"] = mo_run(
        "g, Ehvi f32 mop2 d = 6", loop, mop2, MO_G_DIM, gen, MO_G_ITERS,
        (-1.1, -1.1))
    m = loop.model
    n = MO_G_INIT + MO_G_ITERS
    Y32 = torch.tensor(np.stack(rec.obs), dtype=torch.float32)
    stored = torch.cat([g.y[:n] for g in m.gps], dim=1).cpu()
    if m.n != n or not torch.equal(stored, Y32):
        raise AssertionError("mo path (g): the model's observations are not "
                             "the f32 roundings of the evaluated ones")
    if not torch.equal(stored.max(0).values, Y32.max(0).values):
        raise AssertionError("mo path (g): best observations differ")
    check_finite("mo path (g)", **model_fields(m))
    check_counts("mo path (g)", counts["mo_g"], {
        "gram_train": (2 * (MO_G_ITERS + 1), None),
        "gram": (2 * 50 * MO_G_ITERS, None)})
    with uncounted():
        for j, g in enumerate(m.gps):
            err = max(err, gram_rows_check(
                f"mo path (g) output {j}", g.kernel, torch.rand(
                    (64, MO_G_DIM), generator=gen, device=dev), g.x))
            form, X2, sf2, inv_l = g.kernel._fused_train_args(g.x)
            from limbo_tpu_torch.kernels.base import effective_jitter

            dadd = g.kernel.noise + effective_jitter(torch.float32) \
                * torch.clamp(sf2, min=1.0)
            kk = gp_ops.gram_train_pallas(X2, sf2, inv_l, dadd, g.n, form)
            p = gp_ops.gram_train_plain(X2, sf2, inv_l, dadd, g.n, form)
            err = max(err, check_close(
                f"mo path (g) output {j}: gram_train {form} "
                f"({g.capacity}, n={g.n})", kk, p, 2e-6 + 2e-5 * p.abs(),
                "2e-6 + 2e-5|plain|"))
            out["g"][f"errs{j}"] = check_posterior_exact(g, torch.rand(
                (RESTARTS, MO_G_DIM), generator=gen, device=dev),
                control_rel=MO_CONTROL_REL)
    out["kernel_err"] = err
    del loop, m
    torch.cuda.empty_cache()
    return out, counts


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
    small = kernel_phase(dev, gen, CAPACITY, N_POINTS, 1.0, 0.01)
    large = kernel_phase(dev, gen, HP_CAPACITY, HP_N, HP_ELL, HP_NOISE)
    res = main_path(dev, gen, args.iters)
    torch.cuda.empty_cache()
    hp = hp_path(dev, gen, HP_ITERS)
    torch.cuda.empty_cache()
    bo, bo_counts = bo_path(dev, gen)
    graph, graph_e, graph_c = graph_path(dev, args.seed)
    jit, jit_counts = jit_path(dev, gen)
    suite, suite_counts, sym = suite_path(dev, gen)
    lite, lite_counts, at_lite, lite_data = lite_path(dev, gen)
    modes, modes_counts = modes_path(dev, gen)
    models, models_counts = models_path(dev, gen, lite_data)
    del lite_data
    torch.cuda.empty_cache()
    mo, mo_counts = mo_path(dev, gen)
    by_path = {"n10k": res["launches"], "hp16k": hp["launches"], **bo_counts,
               "graph_eager_n10k": graph_e, "graph_n10k": graph_c,
               **jit_counts, **suite_counts, **lite_counts, **modes_counts,
               **models_counts, **mo_counts}
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")
    extra = ("rel_bias", "at_q64", "at_q1024", "form_ms", "gb_per_s",
             "bytes_share", "launch_floor_ms", "turns", "blocked")
    kernels = []
    for k, e in large.items():
        row = dict(name=k, route=e["route"], source=e["source"],
                   replaces=e["replaces"],
                   launches=sum(c[k] for c in by_path.values()),
                   max_abs_err=e["max_abs_err"], ms=e["ms"],
                   plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
                   bound_by=e["bound_by"], library_ms=e["library_ms"],
                   launches_by_path={p: c[k] for p, c in by_path.items()},
                   at_N=HP_CAPACITY)
        if k in small:
            row[f"at_N{CAPACITY}"] = {x: small[k][x] for x in keys + extra
                                      if x in small[k]}
        row.update({x: e[x] for x in e if x in extra
                    or x.startswith(("at_", "fact", "promotion"))})
        row[f"at_N{LITE_CAPACITY}"] = at_lite[k]
        kernels.append(row)
    kernels.append(dict(
        name="sym_eig", **{x: sym[x] for x in ("route", "source",
                                               "replaces")},
        launches=sum(c["sym_eig"] for c in by_path.values()),
        **{x: sym[x] for x in keys + ("bound_by",)},
        launches_by_path={p: c["sym_eig"] for p, c in by_path.items()}))
    print(json.dumps({"main_path": {
        "iters_per_s": res["iters_per_s"], "fit_s": res["fit_s"],
        "build_s": res["build_s"], "posterior_err": res["errs"],
        "card": card}}))
    print(json.dumps({"hp_path": {
        x: hp[x] for x in ("iters_per_s", "fit_s", "eval_s", "hp_s",
                           "recompute_s", "build_s", "first_iter_s",
                           "peak_gb", "lml", "errs")} | {"card": card}}))
    print(json.dumps({"bo_path": bo | {"card": card}}))
    print(json.dumps({"graph_path": graph | {"card": card}}))
    print(json.dumps({"jit_path": jit | {"card": card}}))
    print(json.dumps({"suite_path": suite | {"card": card}}))
    print(json.dumps({"lite_path": lite | {"card": card}}))
    print(json.dumps({"modes_path": modes | {"card": card}}))
    print(json.dumps({"models_path": models | {"card": card}}))
    print(json.dumps({"mo_path": mo | {"card": card}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
