"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. toolchain: torch, CUDA, the card, its power limit, nvcc, triton;
  2. build the kernels K1 (fused BP) and K2 (GF(2) elimination) with nvcc
     from qldpc_tpu_torch/ops/csrc/;
  3. K1 against its plain torch version on [[144,12,12]] syndromes;
  4. K2 against its plain torch version on the BP failures of phase 3;
  5. the Monte-Carlo engine's sweep on the card, with the kernel launch
     counts of that sweep, its LER held against the reference archive, and
     its counters held against the CPU engine on a small input;
  6. BP(50) throughput of K1 and of the plain torch version.
The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1
and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

CODE = "[[144, 12, 12]]"
# BP(50)+OSD-0 LER of [[144,12,12]] at p = 0.050119 in the reference's
# notebooks/data/BPOSD.npz, 10,000 trials (BASELINE.md table 3).
REF_LER, REF_TRIALS, REF_P = 0.0499, 10_000, 0.050119
DECISION_TOL = 1e-4  # share of lanes allowed to differ in decision (K1)
VALUE_TOL = 1e-5  # rtol = atol on the posteriors of agreeing lanes (K1)
K1_BATCH = 65536  # syndromes per K1 comparison
ENGINE_BATCH, ENGINE_TRIALS = 65536, 262144  # per error rate
THROUGHPUT_BATCH = 262144


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_toolchain(card_line: str) -> None:
    from qldpc_tpu_torch._build import nvcc_path

    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {card_line}")
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    log(f"nvcc: {nvcc.splitlines()[-1]}")
    try:
        import triton  # noqa: F401  (a probe for later work, not a path)

        log(f"triton {triton.__version__} importable")
    except ImportError:
        log("triton not importable")


def phase_build() -> None:
    from qldpc_tpu_torch.ops import bp_cuda, osd_cuda

    for lib in (bp_cuda._LIB, osd_cuda._LIB):
        t0 = time.perf_counter()
        path = lib.build()
        log(f"built {lib.source.name} -> {path.name} in {time.perf_counter() - t0:.2f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
        lib.lib  # load it and bind the entry points


def sample(H: np.ndarray, p: float, B: int, seed: int):
    rng = np.random.default_rng(seed)
    errors = (rng.random((B, H.shape[1])) < p).astype(np.uint8)
    return errors, ((errors.astype(np.int64) @ H.T) % 2).astype(np.uint8)


def phase_k1(H: np.ndarray, dev) -> tuple[float, dict]:
    """K1 against the plain version; returns (max_abs_err, BP failures at p=0.05)."""
    from qldpc_tpu_torch.decoders import BPConfig, BPDecoder
    from qldpc_tpu_torch.ops.bp_cuda import bp_flooding_cuda, bp_flooding_plain

    B = K1_BATCH
    cases = [
        ("sum-product p=0.01", BPConfig(max_iter=50), 0.01),
        ("sum-product p=0.05", BPConfig(max_iter=50), 0.05),
        ("min-sum a=0.8 o=0.1 p=0.05",
         BPConfig(max_iter=50, method="min-sum", alpha=0.8, offset=0.1), 0.05),
    ]
    worst = 0.0
    failures = None
    for name, cfg, p in cases:
        dec = BPDecoder(H, cfg).to(dev)
        _, syn_np = sample(H, p, B, seed=0)
        syn = torch.from_numpy(syn_np).to(dev)
        prior = torch.full((H.shape[1],), math.log((1 - p) / p), dtype=torch.float32, device=dev)
        k = bp_flooding_cuda(syn, prior, dec.tables(), cfg)
        torch.cuda.synchronize()
        r = bp_flooding_plain(syn, prior, dec.tables(), cfg)
        torch.cuda.synchronize()
        kv, kc, ki, kh = k
        rv, rc, ri, rh = r
        differ = (kc != rc) | (ki != ri) | (kh != rh).any(1)
        n_diff = int(differ.sum())
        agree = ~differ
        err = float((kv[agree] - rv[agree]).abs().max()) if bool(agree.any()) else 0.0
        close = torch.allclose(kv[agree], rv[agree], rtol=VALUE_TOL, atol=VALUE_TOL)
        s_hat = (kh.float() @ torch.from_numpy(H.astype(np.float32)).to(dev).T).remainder(2)
        reproduces = bool((s_hat[kc] == syn[kc].float()).all())
        log(f"K1 {name}: B={B} converged {int(kc.sum())} lanes differing in decision "
            f"{n_diff} (limit {DECISION_TOL * B:.1f}) max |dvalues| {err:.3g} "
            f"mean iterations {ki.float().mean().item():.3f}")
        if n_diff > DECISION_TOL * B:
            raise AssertionError(f"K1 {name}: {n_diff} lanes differ in decision")
        if not close:
            raise AssertionError(f"K1 {name}: posteriors differ beyond {VALUE_TOL}")
        if not reproduces:
            raise AssertionError(f"K1 {name}: a converged lane misses its syndrome")
        worst = max(worst, err)
        if name == "sum-product p=0.05":
            fail = ~kc
            failures = dict(syn=syn[fail], llrs=kv[fail], hard=kh[fail])
    return worst, failures


def phase_k2(H: np.ndarray, dev, failures: dict) -> tuple[float, float]:
    """K2 against the plain version on the BP failures; bit-identical.
    Returns the (kernel, plain) milliseconds per call."""
    from qldpc_tpu_torch.decoders import OSDDecoder
    from qldpc_tpu_torch.ops.osd_cuda import (
        eliminate_rows_cuda,
        eliminate_rows_plain,
        pack_rows,
    )

    osd = OSDDecoder(H).to(dev)
    hard = failures["hard"].to(torch.int32)
    resid = (failures["syn"].to(torch.int32)
             + torch.remainder(hard.float() @ osd.Hf.T, 2.0).to(torch.int32)) % 2
    order = torch.argsort(failures["llrs"].abs(), dim=1, stable=True)
    A = pack_rows(osd.H[:, order].permute(1, 0, 2))
    n, lanes = osd.n, A.shape[0]
    ka, kb, kp = eliminate_rows_cuda(A, resid, n, osd.h_rank)
    torch.cuda.synchronize()
    ra, rb, rp = eliminate_rows_plain(A, resid, n, osd.h_rank)
    torch.cuda.synchronize()
    same = torch.equal(ka, ra) and torch.equal(kb, rb) and torch.equal(kp, rp)
    log(f"K2 on {lanes} BP failures (m={osd.m}, n={n}, {A.shape[2]} words, "
        f"rank {osd.h_rank}): bit-identical {same}")
    if not same:
        raise AssertionError("K2 disagrees with its plain version")
    ms = cuda_ms(lambda: eliminate_rows_cuda(A, resid, n, osd.h_rank), reps=5)
    plain_ms = cuda_ms(lambda: eliminate_rows_plain(A, resid, n, osd.h_rank), reps=1)
    log(f"K2 time {ms:.4f} ms, plain {plain_ms:.4f} ms ({lanes} lanes)")
    return ms, plain_ms


def phase_engine(dev, card_line: str) -> dict:
    from qldpc_tpu.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig, OSDConfig
    from qldpc_tpu_torch.mc import EngineConfig, MonteCarloEngine
    from qldpc_tpu_torch.ops import bp_cuda, osd_cuda

    trials = ENGINE_TRIALS
    eng = MonteCarloEngine(
        get_code(CODE),
        EngineConfig(bp=BPConfig(max_iter=50), osd=OSDConfig(order=0),
                     batch_size=ENGINE_BATCH),
        device=dev,
    )
    rates = [0.01, REF_P]
    torch.cuda.synchronize()
    bp_cuda.bp_flooding_cuda.launches = 0
    osd_cuda.eliminate_rows_cuda.launches = 0
    res = eng.sweep(rates, trials=trials)
    torch.cuda.synchronize()
    launches = {
        "bp_flooding": bp_cuda.bp_flooding_cuda.launches,
        "gf2_elim": osd_cuda.eliminate_rows_cuda.launches,
    }
    for p, d in zip(rates, res.per_rate):
        scalars = {k: v for k, v in d.items() if not isinstance(v, np.ndarray)}
        hists = {k: {int(i): int(v[i]) for i in np.nonzero(v)[0]}
                 for k, v in d.items() if isinstance(v, np.ndarray)}
        log(f"engine p={p}: {json.dumps(scalars)}")
        log(f"engine p={p} histograms (weight: count): {json.dumps(hists)}")
    log(f"engine sweep {CODE} BP(50)+OSD-0, {trials} trials per rate, batch {ENGINE_BATCH}: "
        f"wall {res.wall_time_s:.3f} s, {res.throughput:.1f} trials/s on {card_line}")
    log(f"engine kernel launches in the sweep: {json.dumps(launches)}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"the engine's sweep never launched {name}")
    ler = res.per_rate[1]["ler"]
    sigma = math.sqrt(ler * (1 - ler) / trials + REF_LER * (1 - REF_LER) / REF_TRIALS)
    log(f"LER at p={REF_P}: {ler:.5f} against the archive's {REF_LER} "
        f"(limit +-{4 * sigma:.5f})")
    if abs(ler - REF_LER) > 4 * sigma:
        raise AssertionError(f"LER {ler} is outside 4 sigma of {REF_LER}")
    for d in res.per_rate:
        if d["trials"] != trials or d["BPs_fault"] != round(d["osd"] * trials):
            raise AssertionError("engine counters are inconsistent")
    return launches


def phase_engine_vs_cpu(dev) -> None:
    """Small input: the card's engine (K1, K2) against the CPU engine (plain
    versions). Min-sum without alpha is exact arithmetic in both, so the
    counters must be identical."""
    from qldpc_tpu.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig, OSDConfig
    from qldpc_tpu_torch.mc import EngineConfig, MonteCarloEngine, counters_to_dict

    cfg = EngineConfig(bp=BPConfig(max_iter=50, method="min-sum"),
                       osd=OSDConfig(order=0), batch_size=2048)
    code = get_code(CODE)
    got = counters_to_dict(MonteCarloEngine(code, cfg, device=dev).run_rate(0.02, 4096, seed=1))
    ref = counters_to_dict(MonteCarloEngine(code, cfg, device="cpu").run_rate(0.02, 4096, seed=1))
    same = all(np.array_equal(got[k], ref[k]) for k in ref)
    log(f"engine on the card vs the CPU engine, {CODE} min-sum p=0.02, 4096 trials: "
        f"identical {same} (ler {got['ler']:.5f}, BP faults {got['BPs_fault']})")
    if not same:
        raise AssertionError("the card's engine disagrees with the CPU engine")


def phase_throughput(H: np.ndarray, dev, card_line: str) -> tuple[float, float]:
    from qldpc_tpu_torch.decoders import BPConfig, BPDecoder
    from qldpc_tpu_torch.ops.bp_cuda import bp_flooding_cuda, bp_flooding_plain

    B, p = THROUGHPUT_BATCH, 0.01
    cfg = BPConfig(max_iter=50)
    dec = BPDecoder(H, cfg).to(dev)
    _, syn_np = sample(H, p, B, seed=2)
    syn = torch.from_numpy(syn_np).to(dev)
    prior = torch.full((H.shape[1],), math.log((1 - p) / p), dtype=torch.float32, device=dev)
    args = (syn, prior, dec.tables(), cfg)
    ms = cuda_ms(lambda: bp_flooding_cuda(*args), reps=5)
    plain_ms = cuda_ms(lambda: bp_flooding_plain(*args), reps=2)
    log(f"BP(50) {CODE} p={p} B={B}: K1 {ms:.3f} ms = {B / ms * 1e3:.0f} syndromes/s; "
        f"plain torch {plain_ms:.3f} ms = {B / plain_ms * 1e3:.0f} syndromes/s "
        f"on {card_line}")
    return ms, plain_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from qldpc_tpu.codes import get_code  # the repo must be beside the script

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card_line = card()
    H = get_code(CODE).Hx

    phase_toolchain(card_line)
    phase_build()
    k1_err, failures = phase_k1(H, dev)
    k2_ms, k2_plain_ms = phase_k2(H, dev, failures)
    launches = phase_engine(dev, card_line)
    phase_engine_vs_cpu(dev)
    k1_ms, k1_plain_ms = phase_throughput(H, dev, card_line)

    kernels = [
        dict(name="bp_flooding", route="cuda",
             source="qldpc_tpu_torch/ops/csrc/bp_flooding.cu",
             replaces="qldpc_tpu/ops/bp_pallas.py:256",
             launches=launches["bp_flooding"], max_abs_err=k1_err,
             ms=k1_ms, plain_ms=k1_plain_ms),
        dict(name="gf2_elim", route="cuda",
             source="qldpc_tpu_torch/ops/csrc/gf2_elim.cu",
             replaces="qldpc_tpu/ops/osd_pallas.py:36",
             launches=launches["gf2_elim"], max_abs_err=0.0,
             ms=k2_ms, plain_ms=k2_plain_ms),
    ]
    log(card_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
