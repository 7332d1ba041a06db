"""Model serialization: save / load a GP's state to disk (port of
limbo_tpu/utils/serialize.py).

Reference: src/limbo/serialize/{text_archive,binary_archive}.hpp.  limbo
stores the kernel and mean hyperparameters, the samples, observations,
matrixL and alpha (one file per object in a directory), and
GP::load(archive, recompute) optionally rebuilds the factorization from
the data (model/gp.hpp:440-511).

The on-disk layout is the JAX package's, so that an archive written by
either package loads into the other: a directory with ``meta.json`` (the
archive's kind and, per leaf, its key, file and dtype) and one file per
leaf, ``leaf_NNN.npy`` (BinaryArchive) or ``leaf_NNN.txt`` (TextArchive),
numbered in sorted-key order.  The keys are the reference's pytree paths:
``.L``, ``.alpha``, ``.kernel/.<hyperparameter>``, ``.mean/.<...>``,
``.n`` (int32), ``.x``, ``.y``; a module's buffers give the kernel's and
mean's (a nested module's path follows its attribute names).  Loading goes
through ``utils/convert.to_gp``, the mapping that carries a JAX GP across;
the device count ``n_dev`` is not written, it is made from ``n`` on the
template's device.
"""

from __future__ import annotations

import json
import os

import numpy as np

from limbo_tpu_torch.models import gp as gp_mod
from limbo_tpu_torch.utils.convert import to_gp

_GP_FIELDS = ("x", "y", "L", "alpha")


class BinaryArchive:
    """Raw array archive (serialize/binary_archive.hpp:63)."""

    suffix = ".npy"

    @staticmethod
    def write(path: str, arr: np.ndarray):
        np.save(path + BinaryArchive.suffix, arr)

    @staticmethod
    def read(path: str) -> np.ndarray:
        return np.load(path + BinaryArchive.suffix)


class TextArchive:
    """Full-precision text archive (serialize/text_archive.hpp:63)."""

    suffix = ".txt"

    @staticmethod
    def write(path: str, arr: np.ndarray):
        a = np.atleast_2d(np.asarray(arr))
        np.savetxt(path + TextArchive.suffix, a, fmt="%.18e",
                   header=json.dumps({"shape": list(np.shape(arr))}))

    @staticmethod
    def read(path: str) -> np.ndarray:
        with open(path + TextArchive.suffix) as fh:
            header = fh.readline().lstrip("# ").strip()
        shape = tuple(json.loads(header)["shape"])
        if int(np.prod(shape)) == 0:      # loadtxt warns on empty payloads
            return np.zeros(shape)
        a = np.loadtxt(path + TextArchive.suffix)
        return np.reshape(a, shape)


def _module_arrays(prefix: str, module) -> dict:
    return {"/".join(["." + prefix] + ["." + p for p in name.split(".")]):
            buf.detach().cpu().numpy() for name, buf in module.named_buffers()}


def gp_arrays(gp: gp_mod.GP) -> dict:
    """Every array of the GP under the reference's key."""
    out = {"." + k: getattr(gp, k).detach().cpu().numpy()
           for k in _GP_FIELDS}
    out[".n"] = np.asarray(gp.n, dtype=np.int32)
    out.update(_module_arrays("kernel", gp.kernel))
    out.update(_module_arrays("mean", gp.mean))
    return out


def save_gp(gp: gp_mod.GP, directory: str, archive=BinaryArchive) -> None:
    """Write every array of the GP, one file per leaf."""
    os.makedirs(directory, exist_ok=True)
    meta = {"leaves": [], "archive": archive.__name__}
    for i, (key, arr) in enumerate(sorted(gp_arrays(gp).items())):
        fname = f"leaf_{i:03d}"
        archive.write(os.path.join(directory, fname), arr)
        meta["leaves"].append({"key": key, "file": fname,
                               "dtype": str(arr.dtype)})
    with open(os.path.join(directory, "meta.json"), "w") as fh:
        json.dump(meta, fh, indent=1)


def load_gp(template: gp_mod.GP, directory: str, archive=None,
            recompute: bool = False) -> gp_mod.GP:
    """Load into the structure of ``template`` (the kernel and mean classes,
    the shapes), on the template's device, as limbo loads into a
    constructed GP type.  recompute=True rebuilds L and alpha from the
    stored data instead of trusting the stored factorization
    (gp.hpp:466-511)."""
    with open(os.path.join(directory, "meta.json")) as fh:
        meta = json.load(fh)
    if archive is None:
        archive = {"BinaryArchive": BinaryArchive,
                   "TextArchive": TextArchive}[meta["archive"]]
    by_key = {e["key"]: (e["file"], e["dtype"]) for e in meta["leaves"]}
    shapes = {k: a.shape for k, a in gp_arrays(template).items()}
    if set(by_key) != set(shapes):
        raise KeyError(f"archive {directory} holds {sorted(by_key)}, the "
                       f"template {sorted(shapes)}")
    arrays = {}
    for key, shape in shapes.items():
        fname, dtype = by_key[key]
        arr = archive.read(os.path.join(directory, fname)).astype(dtype)
        arrays[key] = np.reshape(arr, shape)
    gp = to_gp(arrays, template.kernel, template.mean,
               device=template.x.device)
    if recompute:
        gp = gp_mod.recompute(gp)
    return gp
