"""The spread of chip_smoke.py's cbo path posterior checks over draws: for
each seed, runs (a) (CBOptimizer in f32 on -Hartmann6 with its
constraint, 4096 init points, 10 iterations) from a generator of that
seed, refits both GPs on the run's samples, and reads each one's f32
posterior at 64 points against the f64 posterior of its stored data, in
units of its move under one f32 rounding of the inputs and distances (the
variance's allowed move also holding its own f32 cancellation; the
variance also in the rule before it), as ``check_posterior_exact`` does,
beside the control (inputs moved by ``CBO_CONTROL_REL``, 2^-8 for the
objective GP, 2^-7 for the constraint GP) in the same units.  The limit
those checks hold is ``BO_SLACK`` (32) units.

    python3 scripts/torch_cbo_spread.py [--seeds 0 1 2 ...]

Needs a card.  Prints one JSON line a seed, then the largest reading and
the smallest control of each GP over the seeds, and the card's name and
power limit."""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from torch_mo_spread import readings, summary  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_cbo_spread.py: no CUDA device", file=sys.stderr)
        return 1
    import limbo_tpu_torch  # noqa: F401  (precision policy: TF32 off)
    from limbo_tpu_torch.bo import MaxIterations, RandomSampling
    from limbo_tpu_torch.bo.cbo import CBOptimizer

    dev = torch.device("cuda")
    rows = []
    for seed in args.seeds:
        gen = torch.Generator(device=dev).manual_seed(seed)
        bo = CBOptimizer(nb_constraints=1, init=RandomSampling(cs.CBO_INIT),
                         stop=(MaxIterations(cs.CBO_ITERS),),
                         dtype=torch.float32, device=dev)
        bo.optimize(cs.cbo_objective, cs.BO_DIM, generator=gen)
        cap = max(64, -(-(cs.CBO_INIT + cs.CBO_ITERS + 1) // 64) * 64)
        model, cmodel = bo.fit(cap)
        Xq = torch.rand((cs.RESTARTS, cs.BO_DIM), generator=gen, device=dev)
        row = dict(seed=seed)
        for name, g in (("objective", model), ("constraint", cmodel)):
            row[name] = readings(g, Xq, cs.CBO_CONTROL_REL[name])
        del bo, model, cmodel
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        rows.append(row)
    runs = ("objective", "constraint")
    print(json.dumps(summary(rows, runs) | {"seeds": args.seeds}))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
