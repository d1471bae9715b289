# Copied from qldpc_tpu/utils/plotting.py: the port keeps its own copy and imports nothing of qldpc_tpu.
"""Plotting utilities: LER curves, failure decomposition, weight histograms,
Tanner graphs and matrix heatmaps.

Covers the reference's analysis layer: the study plots
(studies/study.py:107-168 — log-log LER, degeneracy counts, grouped stacked
failure bars), the rework multi-panel summaries and weight histograms
(rework/main.py:136-251), and drawUtils.py:4-44 (Tanner graph, H heatmap).
Matplotlib is imported lazily so headless decoding paths never pay for it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = [
    "plot_ler_curves",
    "plot_degeneracies",
    "plot_failure_decomposition",
    "plot_weight_histograms",
    "plot_rework_panels",
    "plot_matrix",
    "plot_tanner_graph",
]

CODE_COLORS = ["#2E72AE", "#64B791", "#DBA142", "#000000", "#E17792", "#8E44AD"]


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_ler_curves(results: dict[str, "np.ndarray"], error_rates, path=None, title=None):
    """Log-log LER vs physical error rate, one line per code."""
    plt = _plt()
    fig = plt.figure(figsize=(10, 6))
    for i, (name, lers) in enumerate(results.items()):
        plt.plot(
            error_rates, lers, label=name, marker="o",
            color=CODE_COLORS[i % len(CODE_COLORS)],
        )
    plt.grid(True, which="both", ls="--", alpha=0.6)
    plt.xscale("log")
    plt.yscale("log")
    plt.xlabel("Physical error rate")
    plt.ylabel("Logical error rate")
    if title:
        plt.title(title)
    plt.legend()
    return _finish(fig, path)


def plot_degeneracies(results: dict[str, "np.ndarray"], error_rates, path=None):
    plt = _plt()
    fig = plt.figure(figsize=(10, 6))
    for i, (name, counts) in enumerate(results.items()):
        plt.plot(
            error_rates, counts, label=name, marker="o",
            color=CODE_COLORS[i % len(CODE_COLORS)],
        )
    plt.grid(True)
    plt.xlabel("Physical error rate")
    plt.ylabel("Degenerate corrections")
    plt.legend()
    return _finish(fig, path)


def plot_failure_decomposition(
    per_code: dict[str, dict[str, "np.ndarray"]], error_rates, path=None
):
    """Grouped stacked bars of BPs_fault / miscorrected / incorrectable per
    (code, p) — the study.py:125-168 figure."""
    plt = _plt()
    names = list(per_code)
    x = np.arange(len(error_rates))
    bar_w = 0.12
    fig = plt.figure(figsize=(14, 6))
    parts = [
        ("BPs_fault", "tab:blue"),
        ("BPs_miscorrected", "tab:orange"),
        ("incorrectable", "tab:green"),
    ]
    for i, name in enumerate(names):
        pos = x + i * (bar_w + 0.02)
        bottom = np.zeros(len(error_rates))
        for key, color in parts:
            vals = np.asarray(per_code[name][key], dtype=float)
            plt.bar(
                pos, vals, bar_w, bottom=bottom, color=color,
                label=key if i == 0 else None,
            )
            bottom = bottom + vals
    plt.xticks(
        x + (len(names) - 1) * (bar_w + 0.02) / 2,
        [f"{r:.1e}" for r in error_rates],
    )
    plt.xlabel("Physical error rate")
    plt.ylabel("Failure counts")
    plt.grid(True, axis="y", linestyle="--", alpha=0.6)
    plt.legend(loc="upper left")
    plt.tight_layout()
    return _finish(fig, path)


def plot_weight_histograms(
    hists: dict[str, "np.ndarray"], distances: dict[str, int], path=None,
    max_weight: int = 30, suffix="",
):
    """Residual-weight histograms per code, distance marked
    (rework/main.py:203-226 layout); input = binned counters."""
    plt = _plt()
    names = list(hists)
    fig, axes = plt.subplots(1, max(len(names), 1), figsize=(3 * len(names), 4))
    axes = np.atleast_1d(axes)
    for i, name in enumerate(names):
        h = np.asarray(hists[name])[:max_weight]
        axes[i].bar(np.arange(len(h)), h, color=CODE_COLORS[i % len(CODE_COLORS)], alpha=0.7)
        if name in distances:
            axes[i].axvline(x=distances[name], color="red", linestyle="dashed")
        axes[i].set_title(f"{name} {suffix}")
        axes[i].set_xlabel("Weight")
        axes[i].set_ylabel("Frequency")
    plt.tight_layout()
    return _finish(fig, path)


def plot_rework_panels(results: dict[str, dict[float, dict]], path=None, title=None):
    """Five stacked panels: logical / OSD rate / degeneracies / OSD&error /
    average iterations vs p (rework/main.py:138-201)."""
    plt = _plt()
    keys = [
        ("logical", "Logical Error Rate", True),
        ("osd", "OSD Invocation Rate", False),
        ("degeneracies", "Degenerate Errors Rate", False),
        ("OSD_invocation_AND_logicalError", "OSD Invocation & Error", False),
        ("average_iterations", "Average BP Iterations", False),
    ]
    fig, axes = plt.subplots(len(keys), 1, figsize=(6, 10), sharex=True)
    if title:
        fig.suptitle(title)
    for i, (code_name, per_p) in enumerate(results.items()):
        ps = list(per_p)
        color = CODE_COLORS[i % len(CODE_COLORS)]
        for ax, (key, label, loglog) in zip(axes, keys):
            vals = [per_p[p][key] for p in ps]
            if loglog:
                ax.loglog(ps, vals, marker="d", label=code_name, color=color)
            else:
                ax.plot(ps, vals, marker="o", label=code_name, color=color)
            ax.set_ylabel(label, fontsize=8)
            ax.grid(True, which="both", ls="--", alpha=0.5)
    axes[-1].set_xlabel("Physical Error Rate")
    for ax in axes:
        ax.legend(fontsize=6)
    plt.tight_layout()
    return _finish(fig, path)


def plot_matrix(H, path=None, title=None):
    """Parity-check matrix heatmap (drawUtils.py:37-44)."""
    plt = _plt()
    fig = plt.figure(figsize=(8, 4))
    plt.imshow(np.asarray(H), cmap="binary", aspect="auto", interpolation="nearest")
    if title:
        plt.title(title)
    plt.xlabel("variables")
    plt.ylabel("checks")
    return _finish(fig, path)


def plot_tanner_graph(H, path=None, max_nodes: int = 400):
    """Bipartite Tanner graph layout (drawUtils.py:4-35), pure matplotlib —
    checks on top, variables below, an edge per nonzero of H."""
    plt = _plt()
    H = np.asarray(H)
    m, n = H.shape
    if m + n > max_nodes:
        raise ValueError(f"graph too large to draw ({m}+{n} nodes)")
    fig = plt.figure(figsize=(max(8, n * 0.3), 5))
    xv = np.linspace(0, 1, n)
    xc = np.linspace(0, 1, m)
    for c, v in zip(*np.nonzero(H)):
        plt.plot([xc[c], xv[v]], [1, 0], color="gray", lw=0.6, zorder=1)
    plt.scatter(xc, np.ones(m), s=120, marker="s", color="#DBA142", zorder=2, label="checks")
    plt.scatter(xv, np.zeros(n), s=120, marker="o", color="#2E72AE", zorder=2, label="variables")
    plt.axis("off")
    plt.legend(loc="center right")
    return _finish(fig, path)


def _finish(fig, path):
    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(path, dpi=150)
        import matplotlib.pyplot as plt

        plt.close(fig)
        return Path(path)
    return fig
