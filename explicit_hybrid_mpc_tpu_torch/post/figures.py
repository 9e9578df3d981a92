"""Figures: 2-D partition maps, closed-loop trajectories, runtime curves.

The port's copy of the JAX package's post/figures.py.  All functions
return the matplotlib Figure and optionally save to disk (the Agg
backend is forced).  matplotlib is imported at module level, so this
module is imported only where it is installed; post/__init__ never
imports it.
"""

from __future__ import annotations

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.patches import Polygon  # noqa: E402

from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree  # noqa: E402


def plot_partition_2d(tree: Tree, ax=None, color_by: str = "delta",
                      save: str | None = None):
    """Draw a 2-D partition: one polygon per leaf, colored by commutation
    index ('delta') or depth ('depth'); infeasible/hole leaves hatched."""
    if tree.p != 2:
        raise ValueError(f"partition is {tree.p}-D; 2-D only")
    fig, ax = (ax.figure, ax) if ax is not None else plt.subplots(
        figsize=(7, 6))
    cmap = plt.get_cmap("tab20")
    for i in tree.leaves():
        V = tree.vertices[i]
        ld = tree.leaf_data[i]
        if ld is None:
            ax.add_patch(Polygon(V, closed=True, facecolor="none",
                                 edgecolor="0.6", hatch="///", lw=0.2))
            continue
        key = ld.delta_idx if color_by == "delta" else tree.depth[i]
        ax.add_patch(Polygon(V, closed=True,
                             facecolor=cmap(int(key) % 20),
                             edgecolor="k", lw=0.15, alpha=0.85))
    allv = np.concatenate([tree.vertices[i] for i in tree.leaves()])
    ax.set_xlim(allv[:, 0].min(), allv[:, 0].max())
    ax.set_ylim(allv[:, 1].min(), allv[:, 1].max())
    ax.set_xlabel(r"$\theta_1$")
    ax.set_ylabel(r"$\theta_2$")
    ax.set_title(f"{tree.n_regions()} regions (colored by {color_by})")
    if save:
        fig.savefig(save, dpi=150, bbox_inches="tight")
    return fig


class _Traj:
    """Duck-typed SimResult stand-in for trajectories loaded from a
    PREFIX.sim.json artifact (plain lists)."""

    def __init__(self, d: dict):
        self.states = np.asarray(d["states"])
        self.inputs = np.asarray(d["inputs"])


def plot_closed_loop(sim_results: dict, state_idx=(0, 1), axes=None,
                     save: str | None = None):
    """Overlay closed-loop trajectories in a 2-D state projection plus
    input traces.  Accepts {label: SimResult} from Simulator.run, or a
    CLI PREFIX.sim.json dict (its "trajectories" section is used).
    axes: optional pair of Axes."""
    traj = sim_results.get("trajectories")
    if isinstance(traj, dict) and all(isinstance(v, dict)
                                      for v in traj.values()):
        # CLI sim.json artifact (label -> {"states": ..., "inputs": ...});
        # the type check keeps a {label: SimResult} dict whose label
        # happens to be "trajectories" on the original path.
        sim_results = {k: _Traj(v) for k, v in traj.items()}
    if axes is not None:
        axes = np.asarray(axes).ravel()
        fig = axes[0].figure
    else:
        fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
    for label, res in sim_results.items():
        axes[0].plot(res.states[:, state_idx[0]],
                     res.states[:, state_idx[1]], marker=".", ms=3,
                     label=label)
        axes[1].step(np.arange(len(res.inputs)), res.inputs[:, 0],
                     where="post", label=label)
    axes[0].set_xlabel(f"x[{state_idx[0]}]")
    axes[0].set_ylabel(f"x[{state_idx[1]}]")
    axes[0].legend()
    axes[0].set_title("state trajectory")
    axes[1].set_xlabel("step")
    axes[1].set_ylabel("u[0]")
    axes[1].legend()
    axes[1].set_title("first input channel")
    if save:
        fig.savefig(save, dpi=150, bbox_inches="tight")
    return fig


def plot_runtime(records: list[dict], ax=None, save: str | None = None):
    """Regions and frontier size vs wall time from a RunLog stream."""
    steps = [r for r in records if "step" in r]
    fig, ax = (ax.figure, ax) if ax is not None else plt.subplots(
        figsize=(7, 4.5))
    t = [r["t"] for r in steps]
    ax.plot(t, [r.get("regions", 0) for r in steps], label="regions")
    ax.plot(t, [r.get("frontier", 0) for r in steps], label="frontier")
    ax.set_xlabel("wall time [s]")
    ax.legend()
    ax.set_title("partition build progress")
    if save:
        fig.savefig(save, dpi=150, bbox_inches="tight")
    return fig
