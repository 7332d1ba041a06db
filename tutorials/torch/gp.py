"""GP regression tutorial (the port of tutorials/gp.py, after
src/tutorials/gp.cpp:46-135): fit a GP to noisy cos(x) samples, query a
dense grid, learn an ARD variant's hyperparameters, and save / load the
model.

    python3 tutorials/torch/gp.py                      # on the card
    main(device="cpu")                                 # on the CPU
"""

import os
import tempfile

import numpy as np
import torch

from limbo_tpu_torch.kernels import Exp, SquaredExpARD
from limbo_tpu_torch.means import DataMean
from limbo_tpu_torch.models import gp as gp_mod
from limbo_tpu_torch.models.hp_opt import KernelLFOpt
from limbo_tpu_torch.opt import Rprop
from limbo_tpu_torch.utils.serialize import TextArchive, load_gp, save_gp


def main(device="cuda", seed=0):
    rng = np.random.default_rng(seed)
    N = 40
    X = rng.uniform(0, 1, size=(N, 1)).astype(np.float32)
    Y = (np.cos(10 * X) + 0.1 * rng.normal(size=(N, 1))).astype(np.float32)
    kw = dict(device=device)

    # 1) basic GP with a fixed-hyperparameter Exp kernel
    gp = gp_mod.fit(Exp.create(noise=1e-2, l=0.15, **kw),
                    DataMean.create(**kw), X, Y, **kw)
    Xq = torch.linspace(0, 1, 100, device=gp.x.device)[:, None]
    truth = torch.cos(10 * Xq[:, 0])
    mu, var = gp_mod.query(gp, Xq)
    err1 = float(torch.mean(torch.abs(mu[:, 0] - truth)))
    print("basic GP: mean abs error", err1)

    # 2) ARD kernel + likelihood-maximized hyperparameters
    gp_ard = gp_mod.fit(SquaredExpARD.create(dim=1, **kw),
                        DataMean.create(**kw), X, Y, **kw)
    gp_ard = KernelLFOpt(optimizer=Rprop(iterations=150))(
        gp_ard, torch.Generator(device=gp.x.device).manual_seed(seed))
    mu2, _ = gp_mod.query(gp_ard, Xq)
    err2 = float(torch.mean(torch.abs(mu2[:, 0] - truth)))
    print("ARD GP (hp-opt): mean abs error", err2)
    print("log-lik:", float(gp_mod.log_lik(gp_ard)))

    # 3) serialization round trip (gp.cpp:120-135; the reference saves to
    # ./myGP; a temp dir keeps repeated runs from littering the cwd)
    mydir = os.path.join(tempfile.mkdtemp(), "myGP")
    save_gp(gp_ard, mydir, archive=TextArchive)
    template = gp_mod.empty(SquaredExpARD.create(dim=1, **kw),
                            DataMean.create(**kw), dim_in=1,
                            capacity=gp_ard.capacity, **kw)
    gp_loaded = load_gp(template, mydir)
    mu3, _ = gp_mod.query(gp_loaded, Xq)
    assert float(torch.max(torch.abs(mu3 - mu2))) < 1e-6
    print("saved + loaded OK")
    return dict(basic_err=err1, ard_err=err2, var=var)


if __name__ == "__main__":
    main()
