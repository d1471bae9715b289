"""Single-shot decoding walkthrough (the reference's main.py demo, batched).

    python -m qldpc_tpu_torch.examples.quickstart [--device cpu]

Port of examples/quickstart.py: loads the Steane code, injects a 2-bit
error, decodes with BP, falls back to OSD-0 on failure, and prints every
intermediate quantity. The plots go to ``$QLDPC_PLOT_DIR`` (default: the
temporary directory); without matplotlib the step says so and is skipped.
"""

import argparse
import importlib.util
import os
import tempfile

import numpy as np
import torch

from qldpc_tpu_torch.codes import get_code
from qldpc_tpu_torch.decoders import BPConfig, BPDecoder, OSDConfig, OSDDecoder
from qldpc_tpu_torch.mc.engine import engine_device


def decode(H: np.ndarray, error: np.ndarray, p: float, device) -> dict:
    """BP(50) on the error's syndrome, then OSD-0 where BP does not
    converge: the syndrome, BP's decision, convergence and iterations, and
    the OSD-0 decision (None when BP converged)."""
    prior = torch.from_numpy(np.full(H.shape[1], np.log((1 - p) / p), np.float32)).to(device)
    syndrome = (error @ H.T) % 2
    syn = torch.from_numpy(syndrome[None, :].astype(np.int8)).to(device)
    res = BPDecoder(H, BPConfig(max_iter=50)).to(device)(syn, prior)
    out = dict(syndrome=syndrome, bp=res.hard[0].cpu().numpy(),
               converged=bool(res.converged[0]), iterations=int(res.iterations[0]), osd=None)
    if not out["converged"]:
        osd = OSDDecoder(H, OSDConfig(order=0)).to(device)
        out["osd"] = osd(syn, res.llrs, res.hard)[0].cpu().numpy()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m qldpc_tpu_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    device = engine_device(ap.parse_args(argv).device)

    code = get_code("steane")
    H = code.Hx
    print(f"code: {code.name} [[{code.n}, {code.k}, {code.distance}]]")
    print("H =\n", H)

    # visualize the code (the reference demo's plotMatrix step, main.py:16,
    # plus the Tanner graph of drawUtils.py:4-35)
    out = os.environ.get("QLDPC_PLOT_DIR", tempfile.gettempdir())
    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: no plots")
    else:
        from qldpc_tpu_torch.utils.plotting import plot_matrix, plot_tanner_graph

        plot_matrix(H, os.path.join(out, "steane_matrix.png"), title="Steane Hx")
        plot_tanner_graph(H, os.path.join(out, "steane_tanner.png"))
        print(f"wrote steane_matrix.png / steane_tanner.png to {out}")

    error = np.zeros(code.n, np.int8)
    error[[1, 4]] = 1  # inject a 2-bit error
    d = decode(H, error, 0.1, device)
    print("error    =", error)
    print("syndrome =", d["syndrome"])
    print("BP decision =", d["bp"], "converged =", d["converged"],
          "iterations =", d["iterations"])
    hard = d["bp"]
    if d["osd"] is not None:
        hard = d["osd"]
        print("OSD decision =", hard)

    residual = (hard + error) % 2
    logical = (code.Lx @ residual) % 2
    print("residual =", residual)
    print("logical flip =", logical, "->", "LOGICAL ERROR" if logical.any() else "corrected OK")


if __name__ == "__main__":
    main()
