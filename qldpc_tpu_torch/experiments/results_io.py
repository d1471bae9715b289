# Copied from qldpc_tpu/experiments/results_io.py: the port keeps its own copy and imports nothing of qldpc_tpu.
"""Result archive loading — ours and the reference's.

Parity with loadResults.py:5-23 (reload a pickled results npz and replot),
extended to also parse the reference's archived formats (data/LERS.npz,
rework/simulation_results.npz, notebooks/data/*.npz) so curves can be
overlaid for direct comparison.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["load_results", "load_reference_archive", "replot"]


def load_results(path: str | Path) -> dict:
    """Load an npz written by run_experiment (object-dict payload)."""
    d = np.load(path, allow_pickle=True)
    return d["results"].item()


def load_reference_archive(path: str | Path) -> dict:
    """Load a reference archive into {code_name: {metric_or_p: value}}.

    Handles both shapes the reference uses: driver archives with
    ``physicalErrorRates`` + ``results`` (studies/study.py:105) and rework
    archives with only ``results`` keyed by error rate (rework/main.py:134).
    """
    d = np.load(path, allow_pickle=True)
    out: dict = {}
    if "physicalErrorRates" in d:
        out["physicalErrorRates"] = np.asarray(d["physicalErrorRates"])
    results = d["results"].item() if "results" in d else {}
    for code_name, payload in results.items():
        out[code_name] = payload
    return out


def replot(path: str | Path, out_path: str | Path | None = None):
    """Reload an archive and redraw its LER plot (loadResults.py parity)."""
    from qldpc_tpu_torch.utils import plotting

    results = load_results(path)
    codes = [c for c in results if c != "_meta"]
    rates = {c: sorted(k for k in results[c] if not isinstance(k, tuple)) for c in codes}
    lers = {c: np.array([results[c][p]["ler"] for p in rates[c]]) for c in codes}
    first = codes[0]
    out_path = out_path or Path(path).with_suffix(".replot.png")
    return plotting.plot_ler_curves(lers, rates[first], path=out_path)
