"""Constrained BO and checkpoints of the port on the card (slice 11): a
CBOptimizer iteration through the covariance kernels, and a checkpoint's
round trip and bit-equal resume with the generator on the card.  Marked
``cuda``: without a card each test skips with a reason.  Run them on a
machine with one, beside tests/test_torch_cuda.py:

    python -m pytest tests/test_torch_cuda_persist.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from limbo_tpu_torch.models import gp as gp_mod
from limbo_tpu_torch.ops import _cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels are CUDA only)")
    return torch.device("cuda", 0)


def _bowl(x):
    """A smooth objective on [0, 1]^d, maximum 0 at 0.3."""
    return -np.sum((np.asarray(x, dtype=np.float64) - 0.3) ** 2, keepdims=True)


def _cbo_bowl(x):
    """_bowl and one constraint, feasible (1) iff x[0] <= 0.5."""
    return np.concatenate([_bowl(x), [1.0 if float(x[0]) <= 0.5 else 0.0]])


def test_cbo_iteration_on_the_card(dev):
    """One CBOptimizer iteration in f32 at 600 points: both refits are
    gram_train launches, the ascent's 1024-point sweep a gram launch for
    each GP; ECI on the card's f32 GPs is within 2e-2 of its scale of ECI
    on f64 GPs of the same samples on the CPU (the CPU's f32 GPs read up to
    5e-3 of it at this size)."""
    from limbo_tpu_torch import kernels, means
    from limbo_tpu_torch.bo import MaxIterations, RandomSampling
    from limbo_tpu_torch.bo.cbo import ECI, CBOptimizer

    bo = CBOptimizer(nb_constraints=1, init=RandomSampling(600),
                     stop=(MaxIterations(1),), dtype=torch.float32)
    before = dict(_cuda.LAUNCHES)
    bo.optimize(_cbo_bowl, 4,
                generator=torch.Generator(device=dev).manual_seed(0))
    assert _cuda.LAUNCHES["gram_train"] - before["gram_train"] == 2
    assert _cuda.LAUNCHES["gram"] - before["gram"] >= 2
    assert len(bo.X) == 601 and np.isfinite(np.stack(bo.Yobj)).all()
    assert bo.best_sample[0] <= 0.5
    model, cmodel = bo.fit(640)
    f64 = dict(device="cpu", dtype=torch.float64)
    X = np.stack(bo.X)
    m64 = gp_mod.fit(kernels.MaternFiveHalves.create(**f64),
                     means.DataMean.create(**f64), X, np.stack(bo.Yobj),
                     capacity=640, **f64)
    c64 = gp_mod.fit(kernels.Exp.create(**f64),
                     means.ConstantMean.create(1.0, **f64), X,
                     np.stack(bo.Ycon), capacity=640, **f64)
    Xq = torch.rand((64, 4), generator=torch.Generator(device=dev)
                    .manual_seed(1), device=dev)
    with torch.no_grad():
        got = ECI()(model, cmodel, Xq).cpu().double()
        want = ECI()(m64, c64, Xq.cpu().double())
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= 2e-2 * scale, (err, scale)


def test_checkpoint_roundtrip_and_resume_on_the_card(dev, tmp_path):
    """A checkpoint of a run at the defaults on the card: both archives
    load the saved bits, the generator comes back on the card with its
    state, and 3 + 3 resumed iterations propose the 6 of one run, bit for
    bit."""
    from limbo_tpu_torch.bo import BOptimizer, MaxIterations
    from limbo_tpu_torch.bo.checkpoint import load_state, save_state
    from limbo_tpu_torch.utils.serialize import TextArchive, load_gp, save_gp

    bo = BOptimizer(stop=(MaxIterations(3),))
    st = bo.optimize(_bowl, 6,
                     generator=torch.Generator(device=dev).manual_seed(2))
    save_state(st, str(tmp_path / "ckpt"))
    save_gp(st.gp, str(tmp_path / "text"), archive=TextArchive)
    template = bo._make_gp(6, 1, st.gp.capacity)
    restored = load_state(template, str(tmp_path / "ckpt"))
    text = load_gp(template, str(tmp_path / "text"))
    for g in (restored.gp, text):
        for k in ("x", "y", "L", "alpha"):
            assert torch.equal(getattr(g, k), getattr(st.gp, k)), k
        assert g.x.is_cuda and g.n == st.gp.n and int(g.n_dev) == g.n
    assert restored.generator.device.type == "cuda"
    assert torch.equal(restored.generator.get_state(),
                       st.generator.get_state())
    resumed = bo.optimize(_bowl, 6, reset=False, state=restored,
                          generator=restored.generator)
    whole = BOptimizer(stop=(MaxIterations(6),)).optimize(
        _bowl, 6, generator=torch.Generator(device=dev).manual_seed(2))
    assert resumed.total_iterations == 6 and resumed.gp.n == whole.gp.n == 16
    for k in ("x", "y", "L", "alpha"):
        assert torch.equal(getattr(resumed.gp, k), getattr(whole.gp, k)), k
