"""Typed configuration tree, the BO_PARAM replacement (port of
limbo_tpu/config.py; the port keeps its own copy, so it imports nothing of
the JAX package).

Reference: src/limbo/tools/macros.hpp, limbo's compile-time config
system: every component declares a ``defaults::<name>`` struct of BO_PARAMs
that users override by inheritance (BO_PARAM:53, BO_DYN_PARAM:63 for
runtime-mutable values, BO_PARAMS:112 prints the whole config at startup),
and waf can dump all defaults (waf_tools/limbo.py:371).

Here the same per-component namespacing is a tree of frozen dataclasses:

    cfg = Config()                                  # all defaults
    cfg = cfg.override("acqui_ucb.alpha", 0.7)      # struct Params : ...
    cfg = cfg.override_many({"opt_rprop.iterations": 500})
    print(cfg.pretty())                             # BO_PARAMS
    cfg = Config.from_cli(["--acqui_ucb.alpha=0.7"])  # CLI overrides

Every value is runtime-mutable (BO_DYN_PARAM semantics): the components
read plain Python values when they are built.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Sequence


# -- per-component namespaces (defaults mirror the reference's values) -------

@dataclass(frozen=True)
class KernelCfg:           # defaults::kernel (kernel.hpp:55)
    noise: float = 0.01
    optimize_noise: bool = False


@dataclass(frozen=True)
class KernelExpCfg:        # defaults::kernel_exp (exp.hpp:52)
    sigma_sq: float = 1.0
    l: float = 1.0


@dataclass(frozen=True)
class KernelSqExpARDCfg:   # defaults::kernel_squared_exp_ard (:53)
    k: int = 0
    sigma_sq: float = 1.0


@dataclass(frozen=True)
class KernelMaternCfg:     # defaults::kernel_matern* (:52)
    sigma_sq: float = 1.0
    l: float = 1.0


@dataclass(frozen=True)
class MeanConstantCfg:     # defaults::mean_constant (constant.hpp:52)
    constant: float = 1.0


@dataclass(frozen=True)
class AcquiUcbCfg:         # defaults::acqui_ucb (ucb.hpp:56)
    alpha: float = 0.5


@dataclass(frozen=True)
class AcquiGpucbCfg:       # defaults::acqui_gpucb (gp_ucb.hpp:56)
    delta: float = 0.1


@dataclass(frozen=True)
class AcquiEiCfg:          # defaults::acqui_ei (ei.hpp:58)
    jitter: float = 0.0


@dataclass(frozen=True)
class InitRandomSamplingCfg:   # init/random_sampling.hpp:56
    samples: int = 10


@dataclass(frozen=True)
class InitRandomSamplingGridCfg:  # init/random_sampling_grid.hpp:56
    samples: int = 10
    bins: int = 5


@dataclass(frozen=True)
class InitGridSamplingCfg:     # init/grid_sampling.hpp:55
    bins: int = 5


@dataclass(frozen=True)
class InitLhsCfg:              # init/lhs.hpp:56
    samples: int = 10


@dataclass(frozen=True)
class OptRpropCfg:             # opt/rprop.hpp:58
    iterations: int = 300
    eps_stop: float = 0.0


@dataclass(frozen=True)
class OptAdamCfg:              # opt/adam.hpp:60
    iterations: int = 300
    alpha: float = 0.001
    b1: float = 0.9
    b2: float = 0.999
    eps_stop: float = 0.0


@dataclass(frozen=True)
class OptGradientAscentCfg:    # opt/gradient_ascent.hpp:60
    iterations: int = 300
    alpha: float = 0.001
    gamma: float = 0.0
    nesterov: bool = False
    eps_stop: float = 0.0


@dataclass(frozen=True)
class OptGridSearchCfg:        # opt/grid_search.hpp:59
    bins: int = 5


@dataclass(frozen=True)
class OptParallelRepeaterCfg:  # opt/parallel_repeater.hpp:61
    repeats: int = 10
    epsilon: float = 1e-2


@dataclass(frozen=True)
class OptCmaesCfg:             # opt/cmaes.hpp:66
    restarts: int = 1
    max_fun_evals: int = -1
    iterations: int = 120
    pop_size: int = 0          # 0 = auto (4 + 3 ln d)
    sigma0: float = 0.3
    lbound: float = 0.0
    ubound: float = 1.0


@dataclass(frozen=True)
class OptNsga2Cfg:             # sferes2 NSGA-II replacement
    pop_size: int = 100
    generations: int = 50


@dataclass(frozen=True)
class BayesOptBoBaseCfg:       # bayes_opt/bo_base.hpp:81
    stats_enabled: bool = True
    bounded: bool = True


@dataclass(frozen=True)
class BayesOptBOptimizerCfg:   # bayes_opt/boptimizer.hpp:69
    hp_period: int = -1


@dataclass(frozen=True)
class StopMaxIterationsCfg:    # stop/max_iterations.hpp:53
    iterations: int = 190


@dataclass(frozen=True)
class StopMaxPredictedValueCfg:  # stop/max_predicted_value.hpp:60
    ratio: float = 0.9


@dataclass(frozen=True)
class ModelSparseGpCfg:        # model/sparsified_gp.hpp:55
    max_points: int = 200


@dataclass(frozen=True)
class ModelSpgpCfg:            # experimental/model/spgp.hpp defaults
    pseudo_ratio: float = 0.1
    sig: float = 0.01


@dataclass(frozen=True)
class ModelGpParegoCfg:        # experimental/model/gp_parego.hpp defaults
    rho: float = 0.05


@dataclass(frozen=True)
class Config:
    """The full per-component config tree (≙ a limbo Params struct)."""

    kernel: KernelCfg = field(default_factory=KernelCfg)
    kernel_exp: KernelExpCfg = field(default_factory=KernelExpCfg)
    kernel_squared_exp_ard: KernelSqExpARDCfg = field(
        default_factory=KernelSqExpARDCfg)
    kernel_maternthreehalves: KernelMaternCfg = field(
        default_factory=KernelMaternCfg)
    kernel_maternfivehalves: KernelMaternCfg = field(
        default_factory=KernelMaternCfg)
    mean_constant: MeanConstantCfg = field(default_factory=MeanConstantCfg)
    acqui_ucb: AcquiUcbCfg = field(default_factory=AcquiUcbCfg)
    acqui_gpucb: AcquiGpucbCfg = field(default_factory=AcquiGpucbCfg)
    acqui_ei: AcquiEiCfg = field(default_factory=AcquiEiCfg)
    init_randomsampling: InitRandomSamplingCfg = field(
        default_factory=InitRandomSamplingCfg)
    init_randomsamplinggrid: InitRandomSamplingGridCfg = field(
        default_factory=InitRandomSamplingGridCfg)
    init_gridsampling: InitGridSamplingCfg = field(
        default_factory=InitGridSamplingCfg)
    init_lhs: InitLhsCfg = field(default_factory=InitLhsCfg)
    opt_rprop: OptRpropCfg = field(default_factory=OptRpropCfg)
    opt_adam: OptAdamCfg = field(default_factory=OptAdamCfg)
    opt_gradient_ascent: OptGradientAscentCfg = field(
        default_factory=OptGradientAscentCfg)
    opt_gridsearch: OptGridSearchCfg = field(default_factory=OptGridSearchCfg)
    opt_parallelrepeater: OptParallelRepeaterCfg = field(
        default_factory=OptParallelRepeaterCfg)
    opt_cmaes: OptCmaesCfg = field(default_factory=OptCmaesCfg)
    opt_nsga2: OptNsga2Cfg = field(default_factory=OptNsga2Cfg)
    bayes_opt_bobase: BayesOptBoBaseCfg = field(
        default_factory=BayesOptBoBaseCfg)
    bayes_opt_boptimizer: BayesOptBOptimizerCfg = field(
        default_factory=BayesOptBOptimizerCfg)
    stop_maxiterations: StopMaxIterationsCfg = field(
        default_factory=StopMaxIterationsCfg)
    stop_maxpredictedvalue: StopMaxPredictedValueCfg = field(
        default_factory=StopMaxPredictedValueCfg)
    model_sparse_gp: ModelSparseGpCfg = field(default_factory=ModelSparseGpCfg)
    model_spgp: ModelSpgpCfg = field(default_factory=ModelSpgpCfg)
    model_gp_parego: ModelGpParegoCfg = field(
        default_factory=ModelGpParegoCfg)

    # -- overrides -----------------------------------------------------------

    def override(self, path: str, value: Any) -> "Config":
        """Return a new Config with `namespace.param` replaced (BO_DYN_PARAM)."""
        ns, _, param = path.partition(".")
        if not param:
            raise KeyError(f"override path must be 'namespace.param': {path}")
        sub = getattr(self, ns)
        cur = getattr(sub, param)            # raises if unknown — typed
        value = type(cur)(value) if cur is not None else value
        return dataclasses.replace(
            self, **{ns: dataclasses.replace(sub, **{param: value})})

    def override_many(self, overrides: Dict[str, Any]) -> "Config":
        cfg = self
        for k, v in overrides.items():
            cfg = cfg.override(k, v)
        return cfg

    @classmethod
    def from_cli(cls, argv: Sequence[str]) -> "Config":
        """Parse `--namespace.param=value` CLI overrides."""
        cfg = cls()
        for arg in argv:
            if not arg.startswith("--") or "=" not in arg:
                continue
            path, _, raw = arg[2:].partition("=")
            try:
                value = json.loads(raw)
            except json.JSONDecodeError:
                value = raw
            cfg = cfg.override(path, value)
        return cfg

    # -- introspection (BO_PARAMS / output_params parity) --------------------

    def to_dict(self) -> Dict[str, Dict[str, Any]]:
        return {f.name: dataclasses.asdict(getattr(self, f.name))
                for f in fields(self)}

    def pretty(self) -> str:
        """Printable effective config (limbo BO_PARAMS, macros.hpp:112)."""
        lines = []
        for ns, params in self.to_dict().items():
            for k, v in params.items():
                lines.append(f"{ns}.{k} = {v}")
        return "\n".join(lines)

    def diff(self) -> Dict[str, Any]:
        """Only the non-default values (what the user overrode)."""
        base = Config().to_dict()
        out = {}
        for ns, params in self.to_dict().items():
            for k, v in params.items():
                if base[ns][k] != v:
                    out[f"{ns}.{k}"] = v
        return out
