"""Drive the PyTorch/CUDA port's two paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. toolchain: torch, CUDA, the card, its power limit, nvcc, triton;
  2. build the kernels K1 (fused BP), K2 (GF(2) elimination), K3 (DEM BP)
     and K4 (transform GF(2) elimination) with nvcc from
     qldpc_tpu_torch/ops/csrc/, one nvcc per source, all at once;
  code capacity, [[144,12,12]]:
  3. K1 against its plain torch version;
  4. K2 against its plain torch version on the BP failures of phase 3;
  5. the Monte-Carlo engine's sweep on the card, with the kernel launch
     counts of that sweep, its LER held against the reference archive, and
     its counters held against the CPU engine on a small input;
  6. BP(50) throughput of K1 and of the plain torch version;
  circuit level, the [[72,12,6]] memory-experiment DEM (432 x 15765):
  7. K3 against its plain torch version, B = 1024, sum-product and min-sum;
  8. K4 against its plain torch version on the BP failures of phase 7;
  9. the DEM engine's sweep at p = 0.001 and 0.002, with the kernel launch
     counts of that sweep, its observable error and OSD invocation rates
     held against docs/circuit_ler.md, and its counters held against the
     CPU DEM engine on a small input;
  10. steady-state trials/s of the DEM engine, with the kernels and with
      their plain versions.
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
from concurrent.futures import ThreadPoolExecutor

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

DEM_CODE, DEM_ROUNDS = "[[72, 12, 6]]", 6
# BP(50)+OSD-0 on the [[72,12,6]] Z-memory DEM, rounds = 6, float32 streams,
# 10,000 trials per rate (docs/circuit_ler.md:39-48): p -> (observable
# error rate, OSD invocation rate, mean BP iterations)
DEM_REF = {0.001: (0.0102, 0.424, 26.5), 0.002: (0.0689, 0.700, 38.8)}
DEM_REF_TRIALS = 10_000
DEM_BATCH, DEM_TRIALS = 1024, 10_240  # per error rate
K3_DECISION_TOL = 1  # lanes in 1024 allowed to differ in decision (K3)


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
    from qldpc_tpu_torch.ops import bp_cuda, dem_bp_cuda, osd_cuda, osd_transform_cuda

    libs = [m._LIB for m in (bp_cuda, osd_cuda, dem_bp_cuda, osd_transform_cuda)]

    def build(lib):
        t0 = time.perf_counter()
        path = lib.build()
        return path, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        built = list(pool.map(build, libs))
    for lib, (path, secs) in zip(libs, built):
        log(f"built {lib.source.name} -> {path.name} in {secs:.2f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
        lib.lib  # load it and bind the entry points
    log(f"all kernels built in {time.perf_counter() - t0:.2f} s")


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


def binomial_limit(x: float, n: int, ref: float, n_ref: int) -> float:
    """4 sigma of the difference of two binomial rates."""
    return 4 * math.sqrt(x * (1 - x) / n + ref * (1 - ref) / n_ref)


def dem_engine(dev, cfg_bp=None, batch: int = DEM_BATCH):
    from qldpc_tpu.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig, OSDConfig
    from qldpc_tpu_torch.mc import DEMEngine, DEMEngineConfig
    from qldpc_tpu_torch.noise.dem import parametric_memory_dem

    dem = parametric_memory_dem(get_code(DEM_CODE), basis="z", rounds=DEM_ROUNDS)
    cfg = DEMEngineConfig(bp=cfg_bp or BPConfig(max_iter=50), osd=OSDConfig(order=0),
                          batch_size=batch)
    return DEMEngine(dem, cfg, device=dev, name=f"{DEM_CODE} DEM, rounds {DEM_ROUNDS}")


def phase_k3(eng, dev) -> tuple[float, float, float, dict]:
    """K3 against the plain version on the [[72]] DEM at both rates.
    Returns (max_abs_err, K3 ms, plain ms, BP failures at p = 0.002)."""
    from qldpc_tpu_torch.decoders import BPConfig
    from qldpc_tpu_torch.ops.dem_bp_cuda import dem_bp_cuda, dem_bp_plain

    B, tables = DEM_BATCH, eng.bp.tables()
    worst, failures, times = 0.0, None, None
    for p in DEM_REF:
        prob, llr = eng.priors(p)
        rng = np.random.default_rng(3)
        mech = rng.random((B, eng.n_vars)) < prob.cpu().numpy()
        syn = eng._syndrome(torch.from_numpy(mech.astype(np.int8)).to(dev))
        for method in ("sum-product", "min-sum"):
            cfg = BPConfig(max_iter=50, method=method)
            kv, kc, ki, kh = dem_bp_cuda(syn, llr, tables, cfg)
            torch.cuda.synchronize()
            rv, rc, ri, rh = dem_bp_plain(syn, llr, tables, cfg)
            torch.cuda.synchronize()
            differ = (kc != rc) | (ki != ri) | (kh != rh).any(1)
            n_diff, agree = int(differ.sum()), ~differ
            err = float((kv[agree] - rv[agree]).abs().max()) if bool(agree.any()) else 0.0
            exact = all(torch.equal(a, b) for a, b in ((kv, rv), (kc, rc), (ki, ri), (kh, rh)))
            log(f"K3 {method} p={p}: B={B} converged {int(kc.sum())} mean iterations "
                f"{ki.float().mean().item():.3f} lanes differing in decision {n_diff} "
                f"max |dvalues| {err:.3g} bit-identical {exact}")
            if method == "min-sum" and not exact:
                raise AssertionError(f"K3 min-sum p={p} is not bit-identical to the plain version")
            if n_diff > K3_DECISION_TOL * B / 1024:
                raise AssertionError(f"K3 {method} p={p}: {n_diff} lanes differ in decision")
            if not torch.allclose(kv[agree], rv[agree], rtol=VALUE_TOL, atol=VALUE_TOL):
                raise AssertionError(f"K3 {method} p={p}: posteriors differ beyond {VALUE_TOL}")
            s_hat = eng._syndrome(kh)
            if not bool((s_hat[kc] == syn[kc]).all()):
                raise AssertionError(f"K3 {method} p={p}: a converged lane misses its syndrome")
            worst = max(worst, err)
            if method == "sum-product" and p == 0.002:
                fail = ~kc
                failures = dict(syn=syn[fail], llrs=kv[fail], hard=kh[fail])
            if method == "sum-product" and p == 0.001:
                args = (syn, llr, tables, cfg)
                times = (cuda_ms(lambda: dem_bp_cuda(*args), reps=3),
                         cuda_ms(lambda: dem_bp_plain(*args), reps=1))
    log(f"K3 BP(50) sum-product p=0.001 B={B}: {times[0]:.3f} ms per call, "
        f"plain {times[1]:.3f} ms")
    return worst, times[0], times[1], failures


def phase_k4(eng, failures: dict) -> tuple[float, float]:
    """K4 against the plain version on the BP failures, with and without
    the b-exit; bit-identical. Returns the (kernel, plain) ms per call
    with the b-exit, as OSD-0 runs it."""
    from qldpc_tpu_torch.ops.osd_transform_cuda import (
        eliminate_transform_cuda,
        eliminate_transform_plain,
    )

    osd = eng.osd
    resid = osd._residual(failures["syn"], failures["hard"].to(torch.int32))
    order = torch.argsort(failures["llrs"].abs(), dim=1, stable=True)
    lanes = order.shape[0]
    for b_exit in (True, False):
        # without the b-exit every sample runs to rank(H): the plain version
        # takes seconds per hundred samples there, so it checks the first 128
        keep = lanes if b_exit else 128
        args = (order[:keep], resid[:keep], osd.Hc, osd.h_rank, b_exit)
        got = eliminate_transform_cuda(*args)
        torch.cuda.synchronize()
        ref = eliminate_transform_plain(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        log(f"K4 b_exit={b_exit} on {min(keep, lanes)} BP failures (m={osd.m}, n={osd.n}, "
            f"{osd.m_words} words, rank {osd.h_rank}): mean rank reached "
            f"{got[2].float().mean().item():.1f}, bit-identical {same}")
        if not same:
            raise AssertionError(f"K4 (b_exit={b_exit}) disagrees with its plain version")
    args = (order, resid, osd.Hc, osd.h_rank, True)
    ms = cuda_ms(lambda: eliminate_transform_cuda(*args), reps=5)
    plain_ms = cuda_ms(lambda: eliminate_transform_plain(*args), reps=1)
    log(f"K4 time {ms:.4f} ms, plain {plain_ms:.4f} ms ({lanes} lanes, b-exit on)")
    return ms, plain_ms


def phase_dem_engine(eng, card_line: str) -> dict:
    from qldpc_tpu_torch.ops import dem_bp_cuda, osd_transform_cuda

    rates = list(DEM_REF)
    torch.cuda.synchronize()
    dem_bp_cuda.dem_bp_cuda.launches = 0
    osd_transform_cuda.eliminate_transform_cuda.launches = 0
    res = eng.sweep(rates, trials=DEM_TRIALS)
    torch.cuda.synchronize()
    launches = {
        "dem_bp": dem_bp_cuda.dem_bp_cuda.launches,
        "gf2_transform_elim": osd_transform_cuda.eliminate_transform_cuda.launches,
    }
    log(f"DEM engine sweep {eng.code.name} BP(50)+OSD-0, {DEM_TRIALS} trials per rate, "
        f"batch {DEM_BATCH}: wall {res.wall_time_s:.3f} s, {res.throughput:.1f} trials/s "
        f"(first use included) on {card_line}")
    log(f"DEM engine kernel launches in the sweep: {json.dumps(launches)}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"the DEM engine's sweep never launched {name}")
    for p, d in zip(rates, res.per_rate):
        ref_err, ref_osd, ref_iters = DEM_REF[p]
        scalars = {k: v for k, v in d.items() if not isinstance(v, np.ndarray)}
        log(f"DEM engine p={p}: {json.dumps(scalars)}")
        for name, got, ref in (("obs-err", d["ler"], ref_err), ("OSD rate", d["osd"], ref_osd)):
            lim = binomial_limit(got, d["trials"], ref, DEM_REF_TRIALS)
            log(f"  {name} {got:.5f} against {ref} (limit +-{lim:.5f})")
            if abs(got - ref) > lim:
                raise AssertionError(f"DEM {name} at p={p}: {got} is outside 4 sigma of {ref}")
        log(f"  mean BP iterations {d['average_iterations']:.3f} against {ref_iters}")
        if d["trials"] != DEM_TRIALS or d["BPs_fault"] != round(d["osd"] * DEM_TRIALS):
            raise AssertionError("DEM engine counters are inconsistent")
    return launches


def phase_dem_engine_vs_cpu(dev) -> None:
    """Small input: the card's DEM engine (K3, K4) against the CPU DEM
    engine (plain versions). Min-sum without alpha is exact arithmetic, and
    the priors are computed on the CPU for both, so the counters must be
    identical."""
    from qldpc_tpu_torch.decoders import BPConfig
    from qldpc_tpu_torch.mc import counters_to_dict

    ms = BPConfig(max_iter=50, method="min-sum")
    trials, p = 256, 0.001
    got = counters_to_dict(dem_engine(dev, ms, batch=trials).run_rate(p, trials, seed=1))
    ref = counters_to_dict(dem_engine("cpu", ms, batch=trials).run_rate(p, trials, seed=1))
    same = all(np.array_equal(got[k], ref[k]) for k in ref)
    log(f"DEM engine on the card vs the CPU DEM engine, min-sum p={p}, {trials} trials: "
        f"identical {same} (obs-err {got['ler']:.5f}, BP faults {got['BPs_fault']})")
    if not same:
        raise AssertionError("the card's DEM engine disagrees with the CPU DEM engine")


def phase_dem_throughput(eng, card_line: str) -> None:
    """Steady-state trials/s of the warm DEM engine, four batches per rate,
    and of the same engine on the card with the plain torch versions in
    place of K3 and K4, one batch per rate."""
    from unittest import mock

    from qldpc_tpu_torch.decoders import bp, osd
    from qldpc_tpu_torch.ops.dem_bp_cuda import dem_bp_plain
    from qldpc_tpu_torch.ops.osd_transform_cuda import eliminate_transform_plain

    def rate(p, trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_rate(p, trials, seed=7)
        torch.cuda.synchronize()
        return trials / (time.perf_counter() - t0)

    for p in DEM_REF:
        kernels = rate(p, 4 * DEM_BATCH)
        with mock.patch.object(bp, "dem_bp", dem_bp_plain), \
                mock.patch.object(osd, "eliminate_transform", eliminate_transform_plain):
            plain = rate(p, DEM_BATCH)
        log(f"DEM engine steady state p={p}: {kernels:.1f} trials/s with K3 and K4, "
            f"{plain:.1f} trials/s with their plain versions, on {card_line}")


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

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[{fn.__name__} took {time.perf_counter() - t0:.1f} s]")
        return out

    timed(phase_toolchain, card_line)
    timed(phase_build)
    k1_err, failures = timed(phase_k1, H, dev)
    k2_ms, k2_plain_ms = timed(phase_k2, H, dev, failures)
    launches = timed(phase_engine, dev, card_line)
    timed(phase_engine_vs_cpu, dev)
    k1_ms, k1_plain_ms = timed(phase_throughput, H, dev, card_line)

    eng = timed(dem_engine, dev)
    k3_err, k3_ms, k3_plain_ms, dem_failures = timed(phase_k3, eng, dev)
    k4_ms, k4_plain_ms = timed(phase_k4, eng, dem_failures)
    dem_launches = timed(phase_dem_engine, eng, card_line)
    timed(phase_dem_engine_vs_cpu, dev)
    timed(phase_dem_throughput, eng, card_line)

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
        dict(name="dem_bp", route="cuda",
             source="qldpc_tpu_torch/ops/csrc/dem_bp.cu",
             replaces="qldpc_tpu/ops/dem_bp_pallas.py:78",
             launches=dem_launches["dem_bp"], max_abs_err=k3_err,
             ms=k3_ms, plain_ms=k3_plain_ms),
        dict(name="gf2_transform_elim", route="cuda",
             source="qldpc_tpu_torch/ops/csrc/gf2_transform_elim.cu",
             replaces="qldpc_tpu/ops/osd_transform_pallas.py:37",
             launches=dem_launches["gf2_transform_elim"], max_abs_err=0.0,
             ms=k4_ms, plain_ms=k4_plain_ms),
    ]
    log(card_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
