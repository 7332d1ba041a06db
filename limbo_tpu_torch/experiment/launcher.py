"""Replicated-experiment launcher (port of limbo_tpu/experiment/launcher.py).

Reference: waf_tools/limbo.py:169-357, limbo's only multi-node story: a
JSON conf (exps, nb_runs, res_dir, wall_time, nb_cores, ...) expands into
per-replicate job scripts submitted to Torque (`qsub`, :311) or OAR
(`oarsub`, :339), or run as local threads (:290); replicates never
communicate.

* run_local: replicates as subprocesses, each with its replicate number
  (argv and ``LIMBO_TPU_REPLICATE``, its seed) and the package on its
  ``PYTHONPATH``, run in ``res_dir`` one at a time or ``parallel`` at once.
* generate_job_scripts: one SLURM job file per replicate.

The replicates of a checkout share one kernel build: every process finds
the port's CUDA libraries in ``build/limbo_tpu_torch/`` beside the package,
and a process that has to build one compiles it into a temporary file of
its own and installs it with ``os.replace`` (ops/_cuda.py), so replicates
that start together and build at the same time are safe, and the later
ones load what the first built.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Dict, List, Optional

SLURM_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}_{rep}
#SBATCH --time={wall_time}
#SBATCH --ntasks={nb_hosts}
#SBATCH --output={res_dir}/{name}_{rep}.log
srun python {script} {rep}
"""


def load_conf(path: str) -> Dict:
    with open(path) as fh:
        conf = json.load(fh)
    conf.setdefault("nb_runs", 1)
    conf.setdefault("res_dir", "results")
    conf.setdefault("wall_time", "01:00:00")
    conf.setdefault("nb_hosts", 1)
    return conf


def _exp_script(conf: Dict, exp: str) -> str:
    base = conf.get("bin_dir", os.path.join("exp", exp))
    return os.path.join(base, f"{exp}.py")


def run_local(conf: Dict, parallel: int = 1,
              python: Optional[str] = None) -> List[int]:
    """Run nb_runs replicates of each experiment locally
    (limbo.py run_local:290).  Returns the exit codes, in job order."""
    python = python or sys.executable
    os.makedirs(conf["res_dir"], exist_ok=True)
    jobs = []
    for exp in conf["exps"]:
        script = _exp_script(conf, exp)
        for rep in range(conf["nb_runs"]):
            jobs.append((exp, script, rep))

    codes = []
    running: List = []
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for exp, script, rep in jobs:
        log = open(os.path.join(conf["res_dir"], f"{exp}_{rep}.log"), "w")
        env = dict(os.environ, LIMBO_TPU_REPLICATE=str(rep))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        p = subprocess.Popen([python, os.path.abspath(script), str(rep)],
                             stdout=log, stderr=subprocess.STDOUT,
                             cwd=conf["res_dir"], env=env)
        log.close()
        running.append(p)
        if len(running) >= parallel:
            codes.append(running.pop(0).wait())
    codes.extend(p.wait() for p in running)
    return codes


def generate_job_scripts(conf: Dict, out_dir: Optional[str] = None
                         ) -> List[str]:
    """Write one job script per (exp x replicate) (limbo.py _sub_script:169).

    Submission is left to the cluster user (`sbatch <file>`), as limbo
    writes .job files for qsub / oarsub.
    """
    out_dir = out_dir or conf["res_dir"]
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for exp in conf["exps"]:
        script = os.path.abspath(_exp_script(conf, exp))
        for rep in range(conf["nb_runs"]):
            body = SLURM_TEMPLATE.format(
                name=exp, rep=rep, wall_time=conf["wall_time"],
                nb_hosts=conf.get("nb_hosts", 1),
                res_dir=os.path.abspath(conf["res_dir"]), script=script)
            path = os.path.join(out_dir, f"{exp}_{rep}.job")
            with open(path, "w") as fh:
                fh.write(body)
            os.chmod(path, 0o755)
            paths.append(path)
    return paths
