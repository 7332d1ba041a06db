"""Benchmark result plotting (≙ src/benchmarks/plot_bo_benchmarks.py and
src/benchmarks/regression/plot_regression_benchmarks.py); the port's own
copy of limbo_tpu/benchmarks/plots.py, which it must not import.

Reads the .dat files written by bo_suite / regression_suite and produces
box-plot comparisons of accuracy and wall time per variant x function.
"""

from __future__ import annotations

import glob
import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


def load_bo_results(out_dir: str) -> Dict[str, Dict[str, np.ndarray]]:
    """{variant: {function: (reps, 2) [accuracy, time_ms]}}."""
    results: Dict[str, Dict[str, np.ndarray]] = defaultdict(dict)
    for path in glob.glob(os.path.join(out_dir, "*", "*.dat")):
        variant = os.path.basename(os.path.dirname(path))
        fn = os.path.splitext(os.path.basename(path))[0]
        results[variant][fn] = np.atleast_2d(np.loadtxt(path))
    return dict(results)


def plot_bo_benchmarks(out_dir: str, save: Optional[str] = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    results = load_bo_results(out_dir)
    functions = sorted({f for v in results.values() for f in v})
    variants = sorted(results)
    fig, axes = plt.subplots(2, len(functions), squeeze=False,
                             figsize=(3 * len(functions), 7))
    for j, fn in enumerate(functions):
        for row, (idx, label) in enumerate([(0, "accuracy"), (1, "time (ms)")]):
            data = [results[v][fn][:, idx] for v in variants if fn in results[v]]
            labels = [v for v in variants if fn in results[v]]
            ax = axes[row][j]
            ax.boxplot(data, tick_labels=labels)
            ax.set_title(f"{fn} — {label}", fontsize=9)
            ax.tick_params(axis="x", rotation=45, labelsize=7)
            if idx == 1:
                ax.set_yscale("log")
    fig.tight_layout()
    path = save or os.path.join(out_dir, "bo_benchmarks.png")
    fig.savefig(path, dpi=120)
    return path


def plot_regression_benchmarks(out_dir: str, save: Optional[str] = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.dat"))):
        tag = os.path.splitext(os.path.basename(path))[0]
        data = np.atleast_2d(np.loadtxt(path))
        rows.append((tag, np.median(data[:, 0]), np.median(data[:, 1]),
                     np.median(data[:, 2])))
    if not rows:
        raise FileNotFoundError(f"no .dat files in {out_dir}")
    tags = [r[0] for r in rows]
    fig, axes = plt.subplots(3, 1, figsize=(max(8, 0.4 * len(rows)), 10))
    for ax, idx, label in zip(axes, (1, 2, 3),
                              ("MSE", "learn time (ms)", "query time (ms)")):
        ax.bar(range(len(rows)), [r[idx] for r in rows])
        ax.set_xticks(range(len(rows)))
        ax.set_xticklabels(tags, rotation=90, fontsize=6)
        ax.set_ylabel(label)
        ax.set_yscale("log")
    fig.tight_layout()
    path = save or os.path.join(out_dir, "regression_benchmarks.png")
    fig.savefig(path, dpi=120)
    return path
