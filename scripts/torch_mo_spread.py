"""The spread of chip_smoke.py's mo path posterior checks over draws: for
each seed, runs (f) (optimize_batch q = 4 on -Hartmann6, 4096 init points,
10 rounds) and (g) (Ehvi in f32 on mop2, d = 6, 4096 init points, 5
iterations) from a generator of that seed, then reads each final GP's
(each output's in (g)) f32 posterior at 64 points against the f64
posterior of its stored data, in units of its move under one f32
rounding of the inputs and distances, as ``check_posterior_exact`` does,
beside the control (inputs moved by ``MO_CONTROL_REL``) in the same
units.  The limit those checks hold is ``BO_SLACK`` (32) units.

    python3 scripts/torch_mo_spread.py [--seeds 0 1 2 ...]

Needs a card.  Prints one JSON line a seed, then the largest reading and
the smallest control of each over the seeds, and the card's name and
power limit."""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def readings(gp, Xq, control_rel: float = cs.MO_CONTROL_REL) -> dict:
    """check_posterior_exact's readings, in units of the f32 move, the
    control's inputs moved by ``control_rel``."""
    from limbo_tpu_torch.models import gp as gp_mod

    with torch.no_grad():
        mu, var = gp_mod.query(gp, Xq)
    mu64, var64 = cs.posterior_f64(gp, Xq)
    mu_s, var_s = cs.posterior_f64(gp, Xq, rel=cs.F32_U, dist=True)
    mu_c, var_c = cs.posterior_f64(gp, Xq, rel=control_rel)
    sm = float((mu_s - mu64).abs().max())
    sv = float((var_s - var64).abs().max())
    return dict(
        mu=float((mu[:, 0].double() - mu64[:, 0]).abs().max()) / sm,
        var=float((var.double() - var64).abs().max()) / sv,
        control_mu=float((mu_c - mu64).abs().max()) / sm,
        control_var=float((var_c - var64).abs().max()) / sv)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(6)))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mo_spread.py: no CUDA device", file=sys.stderr)
        return 1
    import limbo_tpu_torch  # noqa: F401  (precision policy: TF32 off)
    from limbo_tpu_torch.acqui.qei import QEI
    from limbo_tpu_torch.bo import BOptimizer, MaxIterations, RandomSampling
    from limbo_tpu_torch.bo.multi import Ehvi
    from limbo_tpu_torch.kernels import SquaredExpARD

    dev = torch.device("cuda")
    rows = []
    for seed in args.seeds:
        gen = torch.Generator(device=dev).manual_seed(seed)
        bo = BOptimizer(kernel=SquaredExpARD.create(dim=cs.BO_DIM,
                                                    device=dev),
                        init=RandomSampling(cs.MO_F_INIT),
                        stop=(MaxIterations(cs.MO_F_ROUNDS),), device=dev)
        state = bo.optimize_batch(cs.hartmann6, cs.BO_DIM, q=4,
                                  generator=gen, qei=QEI(n_samples=128),
                                  restarts=16, steps=30)
        row = dict(seed=seed, f=readings(state.gp, torch.rand(
            (cs.RESTARTS, cs.BO_DIM), generator=gen, device=dev)))
        del state, bo
        loop = Ehvi(ref=(-1.1, -1.1), init=RandomSampling(cs.MO_G_INIT),
                    stop=(MaxIterations(cs.MO_G_ITERS),),
                    dtype=torch.float32, device=dev)
        loop.optimize(cs.mop2, cs.MO_G_DIM, generator=gen)
        for j, g in enumerate(loop.model.gps):
            row[f"g{j}"] = readings(g, torch.rand(
                (cs.RESTARTS, cs.MO_G_DIM), generator=gen, device=dev))
        del loop
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        rows.append(row)
    runs = [k for k in rows[0] if k != "seed"]
    print(json.dumps({
        "max_reading": {k: max(max(r[k]["mu"], r[k]["var"]) for r in rows)
                        for k in runs},
        "min_control": {k: min(min(r[k]["control_mu"], r[k]["control_var"])
                               for r in rows) for k in runs},
        "limit": cs.BO_SLACK, "seeds": args.seeds}))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
