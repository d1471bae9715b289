"""A short first check of the factored elimination (K5a-d) on one CUDA device.

    python3 scripts/probe_factored_k5.py

Builds every kernel of the port (one nvcc per source, all at once) and
prints the ptxas lines of K5, then, on the [[144,12,12]] Z-memory DEM
(rounds 12) at batch 1,024 and p = 0.002: one K3 BP(50) call, the factored
elimination on its BP failures against the plain version (8 and 64 of
them), and two timed runs on all of them. Imports no JAX. Needs CUDA.
"""

from __future__ import annotations

import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from qldpc_tpu_torch.codes import get_code  # noqa: E402
from qldpc_tpu_torch.decoders import BPConfig, OSDConfig  # noqa: E402
from qldpc_tpu_torch.mc import DEMEngine, DEMEngineConfig  # noqa: E402
from qldpc_tpu_torch.noise.circuit import parametric_memory_dem  # noqa: E402
from qldpc_tpu_torch.ops import (  # noqa: E402
    bp_cuda,
    dem_bp_cuda,
    osd_cuda,
    osd_transform_cuda,
)
from qldpc_tpu_torch.ops import osd_factored_cuda as ofc  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_factored_k5: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = [m._LIB for m in (bp_cuda, osd_cuda, dem_bp_cuda, osd_transform_cuda, ofc)]
    t0 = time.time()
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs))
    print("built in", time.time() - t0, flush=True)
    for line in ofc._LIB.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(" ", line.strip())
    dev = torch.device("cuda")
    t0 = time.time()
    dem = parametric_memory_dem(get_code("[[144, 12, 12]]"), basis="z", rounds=12)
    cfg = DEMEngineConfig(bp=BPConfig(max_iter=50), osd=OSDConfig(), batch_size=1024)
    eng = DEMEngine(dem, cfg, device=dev)
    osd = eng.osd
    print("engine built", time.time() - t0, osd.elimination, osd.h_rank, osd.max_cols, flush=True)
    prob, llr = eng.priors(0.002)
    rng = np.random.default_rng(3)
    mech = rng.random((1024, eng.n_vars)) < prob.cpu().numpy()
    syn = eng._syndrome(torch.from_numpy(mech.astype(np.int8)).to(dev))
    torch.cuda.synchronize()
    t0 = time.time()
    res = eng.bp(syn, llr)
    torch.cuda.synchronize()
    fail = ~res.converged
    print("K3 BP", time.time() - t0, "failures", int(fail.sum()), flush=True)
    resid = osd._residual(syn[fail], res.hard[fail].to(torch.int32))
    order = torch.argsort(res.llrs[fail].abs(), dim=1, stable=True)
    for lanes in (8, 64):
        args = (order[:lanes], resid[:lanes], osd.Hc, osd.h_rank, osd.max_cols)
        t0 = time.time()
        got = ofc.eliminate_factored_cuda(*args)
        torch.cuda.synchronize()
        tk = time.time() - t0
        t0 = time.time()
        ref = ofc.eliminate_factored_plain(*args)
        torch.cuda.synchronize()
        tp = time.time() - t0
        same = [torch.equal(a, b) for a, b in zip(got, ref)]
        print(f"K5 lanes {lanes}: kernel {tk:.3f} s plain {tp:.3f} s identical {same} "
              f"overflow {int(got[3].sum())} rank {got[1].sum(1).float().mean().item():.1f}",
              flush=True)
    args = (order, resid, osd.Hc, osd.h_rank, osd.max_cols)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        ofc.eliminate_factored_cuda(*args)
        torch.cuda.synchronize()
        print(f"K5 all {order.shape[0]} lanes: {time.time() - t0:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
