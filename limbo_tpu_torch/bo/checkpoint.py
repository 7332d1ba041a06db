"""BO run checkpoint / resume (port of limbo_tpu/bo/checkpoint.py).

Reference capability: limbo's two resume mechanisms, model serialization
(serialize/*_archive.hpp) plus ``optimize(reset=false)``, which keeps the
samples and total_iterations (bo_base.hpp:249-260).

A checkpoint is a directory: the GP (utils/serialize.py, under ``model/``)
and ``state.json`` with the iteration counters and the generator's state
(``torch.Generator.get_state()``, where the reference stores its key).  The
K^{-1} query cache is not saved, as in the reference: a resumed cached run
rebuilds it from the GP.  Resume with

    state = load_state(template_gp, directory)
    bo.optimize(f, d, reset=False, state=state, generator=state.generator)
"""

from __future__ import annotations

import json
import os

import torch

from limbo_tpu_torch.acqui.acqui import FirstElem
from limbo_tpu_torch.bo.optimizer import BOState
from limbo_tpu_torch.models import gp as gp_mod
from limbo_tpu_torch.utils.serialize import BinaryArchive, load_gp, save_gp


def save_state(state: BOState, directory: str,
               archive=BinaryArchive) -> None:
    os.makedirs(directory, exist_ok=True)
    save_gp(state.gp, os.path.join(directory, "model"), archive=archive)
    meta = {
        "iteration": int(state.iteration),
        "total_iterations": int(state.total_iterations),
        "generator": state.generator.get_state().tolist(),
    }
    with open(os.path.join(directory, "state.json"), "w") as fh:
        json.dump(meta, fh)


def load_state(template_gp: gp_mod.GP, directory: str,
               aggregator=None) -> BOState:
    """The saved BOState, its GP and a generator on the template's
    device."""
    gp = load_gp(template_gp, os.path.join(directory, "model"))
    with open(os.path.join(directory, "state.json")) as fh:
        meta = json.load(fh)
    generator = torch.Generator(device=gp.x.device)
    generator.set_state(torch.tensor(meta["generator"], dtype=torch.uint8))
    return BOState(gp=gp, generator=generator,
                   iteration=meta["iteration"],
                   total_iterations=meta["total_iterations"],
                   aggregator=aggregator if aggregator is not None
                   else FirstElem)
