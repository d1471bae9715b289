"""Probe K4g (the transform elimination past K4's block): where a sample's
time goes, per step and per panel, at each cluster width.

    python3 scripts/probe_k4g.py [--old-csrc DIR] [--out chiprun_out/probe_k4g]
    python3 scripts/probe_k4g.py --layouts [--inputs 144 288 st288]
    python3 scripts/probe_k4g.py --count-cpu --code "[[144, 12, 12]]" --lanes 4

On the card (the default) it builds a second instance of
``gf2_transform_elim_global.cu`` with ``-DK4G_PROBE`` prepended (a copy in
the git-ignored build directory; the package's own build never defines
it), whose thread 0 of every block adds clock64() cycles per step and
counts per panel into a buffer, and runs it on three inputs:

  144   phase 14c's 128 out-of-image [[144,12,12]] DEM lanes (BP failures at
        p = 0.002 with a detector flipped that a dependency of H involves);
  288   phase 23b's 4 such lanes of the [[288,12,18]] DEM (phase 23's
        complete-bposd engine, float32 streams, OSD-e(7), p = 0.003);
  st288 BP failures of [[288,12,18]] space-time at T = 18 (H_st 2,592 x
        7,776, p = 0.008, the space-time preset's BP(100)), as chip_smoke.py's
        phase 24 takes them: H_st's rows are independent, so none leaves its
        image, and K4g runs without the b-exit, every lane to rank(H) (the
        timing phase 24 no longer takes);
  wide  chip_smoke.py's synthetic systems past 9,312 rows (WIDE_SIZES, 2
        lanes each, one outside H's image, the b-exit on), which K4g runs in
        its spilled layout (--old-csrc does not take them).

With --layouts it instead times, on the 144, 288 and st288 inputs (and
the [[288]] DEM's BP failures past the factored column budget, phase 23's
OSD-0 traffic), each with all its lanes and with one, K4g's shared layout
at launch_shape's choice against its spilled layout at the same cluster
width, in turns, both held to the plain version bit for bit.

For each it prints, at every cluster width C (1 to 16) with T in shared
memory where the cluster holds it and in global memory: the device ms of
the tree's kernel (CUDA events, median of --reps), bit-identity with the
kernel at launch_shape's choice, the panels, those with no pivot, the
leader's cycles per step per panel (stage wait, step 1, the words at or
below the rank, barrier 1, the gather, the elimination, the write-back,
barrier 2, the rows above the rank and U, barrier 3, the update), the list
length and the rows at or below the rank per pivot panel, and the rows
above the rank holding a bit. With --old-csrc (an earlier tree's csrc, e.g.
commit a4083d2) its K4g is timed in turns with the tree's. Then, with
--traffic, the share of BP failures past the factored column budget (the
samples K4g solves on in-image syndromes) for one batch of 1,024 at the
[[288]] DEM, p = 0.0015, 0.002 and 0.003, and the [[144]] DEM, p = 0.002,
with complete-bposd's engine and osd_order = 7.

``--count-cpu`` counts the same walk on the CPU with the plain elimination
(no card): for a few out-of-image lanes of the DEM given (a small batch of
the CPU engine), per lane the columns walked, the panels and those with no
pivot, the rows at or below the rank and the list rows per pivot panel, and
the rows above the rank holding a panel bit.

Prints the card's name and power limit first; a JSON summary goes to
--out. Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from qldpc_tpu_torch._build import BUILD_DIR, CSRC_DIR, KernelLibrary  # noqa: E402
from qldpc_tpu_torch.ops import osd_transform_cuda as otc  # noqa: E402

_vp, _i = ctypes.c_void_p, ctypes.c_int
LAUNCH = [_vp] * 7 + [ctypes.c_longlong] + [_i] * 9 + [_vp]
# the entry point of the K4g before the spilled layout (commit 0e1c511)
OLD_LAUNCH = [_vp] * 6 + [_i] * 8 + [_vp]
# the probe buffer's counters (gf2_transform_elim_global.cu, K4G_PROBE)
STEPS = {1: "stage wait", 2: "step 1", 3: "words at/below rank", 4: "barrier 1",
         6: "gather", 7: "eliminate", 8: "write-back", 9: "barrier 2",
         10: "above rank + U", 11: "barrier 3", 17: "update", 18: "end wait", 19: "final write"}
NPROBE = 24
WIDTHS = (1, 2, 4, 8, 16)


def log(msg: str) -> None:
    print(msg, flush=True)


def probe_library(threads: int | None = None, probe: bool = True) -> KernelLibrary:
    """A copy of the tree's K4g source with K4G_PROBE defined, and THREADS
    where given (else the source's block size)."""
    src = CSRC_DIR / "gf2_transform_elim_global.cu"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    name = f"gf2_transform_elim_global_{'probe' if probe else 'plain'}{threads or ''}.cu"
    defines = ("#define K4G_PROBE\n" if probe else "") + (
        f"#define THREADS {threads}\n" if threads else "")
    (BUILD_DIR / name).write_text(defines + src.read_text())
    declare = {"gf2_transform_elim_global_launch": LAUNCH,
               "gf2_transform_elim_global_max_clusters": [_i] * 5}
    if probe:  # the probe's build alone exports this
        declare["gf2_transform_elim_global_set_probe"] = [_vp]
    return KernelLibrary(str(BUILD_DIR / name), declare)


def launch(lib, args, C: int, t_smem: bool, probe: torch.Tensor | None = None,
           spill: bool | None = None):
    """One launch of ``lib``'s K4g (the tree's or the probe's entry point),
    in the layout ``global_spills`` picks, or with ``spill`` True in the
    spilled one at any size (T in global memory, 17 bytes a slot)."""
    order, b, Hc, h_rank, b_exit = args
    m = b.shape[1]
    B, n = order.shape
    if spill is None:
        spill = otc.global_spills(m)
    if spill != otc.global_spills(m):  # the mirrors' formulas for the other layout
        m_pad = -(-m // 32) * 32
        smem = 17 * -(-m // C) if spill else otc._shared_layout_bytes(m, C, t_smem)
        ws_words = 3 * m_pad * (B * C + B) if spill else 0
    else:
        smem, ws_words = otc.global_smem_bytes(m, C, t_smem), otc.global_workspace_words(m, B, C)
    order32, Hc, b, T, rank, piv = otc._operands("probe", order, b, Hc, smem,
                                                 otc.GLOBAL_SMEM_LIMIT)
    if probe is not None:
        lib.call("gf2_transform_elim_global_set_probe", probe.data_ptr())
    ws = torch.empty(max(ws_words, 1), dtype=torch.int32, device=b.device)
    lib.call("gf2_transform_elim_global_launch", order32.data_ptr(), Hc.data_ptr(),
             T.data_ptr(), b.data_ptr(), rank.data_ptr(), piv.data_ptr(), ws.data_ptr(),
             ws_words, B, m, Hc.shape[1], n, h_rank, int(b_exit), C, int(t_smem),
             int(spill), torch.cuda.current_stream(b.device).cuda_stream)
    return T, b, rank, piv


def layout_turns(name: str, args, rounds: int) -> dict:
    """K4g's two layouts on one input at or below 9,312 rows, in turns
    (shared, spilled, spilled, shared, ``rounds`` times; with T in shared
    memory also the shared layout with T in global memory): the shared
    layout at ``global_launch_shape``'s choice, the spilled one at the same
    C with T in global memory. Device ms of each launch (CUDA events), every
    output bit-identical to the plain version's."""
    order, b, Hc, h_rank, b_exit = args
    B, m = b.shape
    sms = torch.cuda.get_device_properties(b.device).multi_processor_count
    C, ts, _ = otc.global_launch_shape(m, B, sms, otc.wide_clusters(b.device, m))
    ref = otc.eliminate_transform_plain(*args)
    runs = {"shared": lambda: launch(otc._GLOBAL_LIB, args, C, ts, spill=False),
            "spilled": lambda: launch(otc._GLOBAL_LIB, args, C, False, spill=True)}
    if ts:
        runs["shared_gmem"] = lambda: launch(otc._GLOBAL_LIB, args, C, False, spill=False)
    order_ = ["shared", "spilled", "spilled", "shared"] + (["shared_gmem"] * 2 if ts else [])
    launch(otc._GLOBAL_LIB, args, C, False, spill=True)  # the spilled instance's first use
    turns = []
    for _ in range(rounds):
        for who in order_:
            ms, got = device_ms(runs[who], 1)
            if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                raise AssertionError(f"{name}: the {who} layout differs from the plain version")
            turns.append((who, ms))
    med = {w: float(np.median([ms for who, ms in turns if who == w])) for w in runs}
    log(f"{name}: {B} lanes, {m} rows, C = {C}, T in {'shared' if ts else 'global'} memory "
        f"(the shared layout's choice); device ms in turns: " + ", ".join(
            f"{w} {ms:.3f}" for w, ms in turns) + "; medians " + ", ".join(
            f"{w} {ms:.3f}" for w, ms in med.items()) +
        f"; spilled / shared {med['spilled'] / med['shared']:.3f}; bit-identical to plain")
    return dict(lanes=B, m=m, C=C, t_smem=ts, turns=turns, medians=med,
                spilled_over_shared=med["spilled"] / med["shared"])


def launch_old(lib, args, C: int, t_smem: bool):
    """One launch of the earlier K4g's entry point (``OLD_LAUNCH``) at the
    tree's choice of C and T's place, which it shares up to 9,312 rows."""
    order, b, Hc, h_rank, b_exit = args
    m = b.shape[1]
    order32, Hc, b, T, rank, piv = otc._operands("old", order, b, Hc, 0, 1)
    B, n = order.shape
    lib.call("gf2_transform_elim_global_launch", order32.data_ptr(), Hc.data_ptr(),
             T.data_ptr(), b.data_ptr(), rank.data_ptr(), piv.data_ptr(),
             B, m, Hc.shape[1], n, h_rank, int(b_exit), C, int(t_smem),
             torch.cuda.current_stream(b.device).cuda_stream)
    return T, b, rank, piv


def device_ms(fn, reps: int) -> tuple[float, object]:
    times, out = [], None
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    return float(np.median(times)), out


def summarize(buf: torch.Tensor, B: int, C: int) -> dict:
    """The probe buffer (B * C blocks x NPROBE): the leader's per-step cycles
    per panel, the panel counts and the per-panel row counts."""
    x = buf.view(B, C, NPROBE).double().cpu()
    lead = x[:, 0]
    panels, pivot_panels = lead[:, 0], lead[:, 5]
    tot = lambda k: float(lead[:, k].sum())  # noqa: E731
    out = {
        "panels_mean": float(panels.mean()), "panels_max": float(panels.max()),
        "pivot_panels_mean": float(pivot_panels.mean()),
        "no_pivot_share": 1 - tot(5) / max(tot(0), 1),
        "list_rows_per_pivot_panel": tot(12) / max(tot(5), 1),
        "rows_at_or_below_rank_per_pivot_panel": tot(13) / max(tot(5), 1),
        "words_computed_at_or_below_rank_per_panel": float(x[:, :, 14].sum()) / max(tot(0), 1),
        "rows_above_rank_holding_a_bit_per_pivot_panel": float(x[:, :, 15].sum()) / max(tot(5), 1),
        "rows_updated_per_pivot_panel": float(x[:, :, 16].sum()) / max(tot(5), 1),
        "cycles_total_max": float(x[:, :, 20].max()),
        "rank_mean": float(lead[:, 22].mean()),
    }
    out["leader_cycles_per_panel"] = {name: tot(k) / max(tot(0), 1) for k, name in STEPS.items()}
    out["leader_cycles_per_pivot_panel"] = {
        name: tot(k) / max(tot(5), 1) for k, name in STEPS.items() if k in (6, 7, 8, 9, 10, 11, 17)}
    return out


def widths(m: int, only: tuple[int, ...] | None) -> list[tuple[int, bool]]:
    shapes = []
    for C in only or WIDTHS:
        if otc.global_smem_bytes(m, C, True) <= otc.GLOBAL_SMEM_LIMIT:
            shapes.append((C, True))
        if otc.global_smem_bytes(m, C, False) <= otc.GLOBAL_SMEM_LIMIT:
            shapes.append((C, False))
    return shapes


def probe_input(name: str, args, probe_lib, old_lib, reps: int, only, variants: dict) -> dict:
    order, b, Hc, h_rank, b_exit = args
    B, m = b.shape
    sms = torch.cuda.get_device_properties(b.device).multi_processor_count
    C0, ts0, waves0 = otc.global_launch_shape(m, B, sms, otc.wide_clusters(b.device, m))
    tree = otc.eliminate_transform_global_cuda
    ref = tree(*args)
    torch.cuda.synchronize()
    log(f"{name}: {B} lanes, {m} rows, rank(H) {h_rank}; launch_shape's choice C = {C0}, T in "
        f"{'shared' if ts0 else 'global'} memory, {waves0} wave(s)")
    rec = {"lanes": B, "m": m, "choice": [C0, ts0], "shapes": []}
    for C, t_smem in widths(m, only):
        fit = probe_lib.lib.gf2_transform_elim_global_max_clusters(
            m, Hc.shape[1], C, int(t_smem), int(otc.global_spills(m)))
        if fit <= 0:
            log(f"  C={C:2d} T in {'smem' if t_smem else 'gmem'}: no cluster fits ({fit})")
            continue
        ms, got = device_ms(lambda: launch(otc._GLOBAL_LIB, args, C, t_smem), reps)
        same = all(torch.equal(g, r) for g, r in zip(got, ref))
        buf = torch.zeros(B * C * NPROBE, dtype=torch.int64, device=b.device)
        pgot = launch(probe_lib, args, C, t_smem, buf)
        torch.cuda.synchronize()
        same = same and all(torch.equal(g, r) for g, r in zip(pgot, ref))
        s = summarize(buf, B, C)
        s.update(C=C, t_smem=t_smem, device_ms=ms, identical=same, max_clusters=fit)
        rec["shapes"].append(s)
        steps = ", ".join(f"{k} {v:.0f}" for k, v in s["leader_cycles_per_panel"].items())
        log(f"  C={C:2d} T in {'smem' if t_smem else 'gmem'}: {ms:.3f} device ms (median of "
            f"{reps}), identical {same}, {s['max_clusters']} clusters at once; panels "
            f"{s['panels_mean']:.1f} mean / {s['panels_max']:.0f} max, no pivot "
            f"{100 * s['no_pivot_share']:.1f}%; per pivot panel: list {s['list_rows_per_pivot_panel']:.1f}"
            f" rows, at/below rank {s['rows_at_or_below_rank_per_pivot_panel']:.1f}, above rank "
            f"holding a bit {s['rows_above_rank_holding_a_bit_per_pivot_panel']:.1f}, updated "
            f"{s['rows_updated_per_pivot_panel']:.1f}; words computed at/below rank per panel "
            f"{s['words_computed_at_or_below_rank_per_panel']:.1f}")
        log(f"    leader cycles per panel: {steps}")
        log("    leader cycles per pivot panel: " + ", ".join(
            f"{k} {v:.0f}" for k, v in s["leader_cycles_per_pivot_panel"].items()))
        for vname, vlib in variants.items():
            vms, vgot = device_ms(lambda: launch(vlib, args, C, t_smem), reps)
            s[f"{vname}_device_ms"] = vms
            same = same and all(torch.equal(g, r) for g, r in zip(vgot, ref))
            log(f"    {vname}: {vms:.3f} device ms, identical {same}")
        if not same:
            raise AssertionError(f"{name}: C={C} t_smem={t_smem} differs from launch_shape's choice")
    if old_lib is not None and not otc.global_spills(m):
        turns = []
        for who in ("old", "tree", "tree", "old"):
            fn = (lambda: launch_old(old_lib, args, C0, ts0)) if who == "old" \
                else (lambda: tree(*args))
            ms, got = device_ms(fn, 1)
            if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                raise AssertionError(f"{name}: the earlier K4g differs from the tree's")
            turns.append((who, ms))
        rec["turns"] = turns
        log(f"  in turns (device ms): " + ", ".join(f"{w} {ms:.3f}" for w, ms in turns))
    return rec


def prepared(osd, syn, llrs, hard, b_exit: bool = True):
    hard = hard.to(torch.int32)
    resid = osd._residual(syn, hard)
    order = torch.argsort(llrs.abs(), dim=1, stable=True)
    return order, resid, osd.Hc[:osd.n], osd.h_rank, b_exit


def preset_engine(dev, code: str, p: float, out_dir: str):
    """complete-bposd's engine for ``code`` (float32 streams, OSD-e(7)), as
    chip_smoke.py's phase 23 builds it, after one batch at p."""
    from qldpc_tpu_torch.experiments import get_preset, run_experiment

    spec = get_preset("complete-bposd").replace(
        codes=[code], error_rates=[p], trials=cs.DEM288_BATCH, batch_size=cs.DEM288_BATCH,
        bp_stream_dtype="float32", osd_order=cs.PH_ORDER, output_dir=out_dir)
    patch, engines, _ = cs.capture_engines()
    with patch:
        run_experiment(spec, device=dev, checkpoint=False)
    return engines[0]


def past_budget(eng, p: float, seed: int = 7) -> dict:
    from qldpc_tpu_torch.ops import osd_factored_cuda

    syn, llrs, hard = cs.dem_failures(eng, p, seed)
    osd = eng.osd
    over = osd_factored_cuda.eliminate_factored_cuda(
        torch.argsort(llrs.abs(), dim=1, stable=True), osd._residual(syn, hard.to(torch.int32)),
        osd.Hc, osd.h_rank, osd.max_cols)[3]
    return {"p": p, "batch": eng.config.batch_size, "bp_failures": len(syn),
            "past_budget": int(over.sum()), "budget": osd.max_cols}


def layouts(args, dev, card_line: str) -> dict:
    """``--layouts``: the shared layout against the spilled one in turns
    (``layout_turns``) on the inputs the decoder gives K4g at or below
    9,312 rows, each with all its lanes and with its first lane alone: the
    [[144]] DEM's out-of-image lanes (phase 14c's), the [[288]] DEM's
    (phase 23b's) and its BP failures past the factored column budget at
    p = 0.003 (phase 23's OSD-0 traffic, seed 7), and [[288]] space-time's
    BP failures without the b-exit (--st-lanes)."""
    import tempfile

    from qldpc_tpu_torch.decoders import OSDConfig, OSDDecoder
    from qldpc_tpu_torch.ops import osd_factored_cuda
    from qldpc_tpu_torch.utils import rng

    out = {"card": card_line, "layouts": {}}

    def both(name, a):
        out["layouts"][name] = layout_turns(name, a, args.rounds)
        one = (a[0][:1], a[1][:1], *a[2:])
        out["layouts"][f"{name}, lane 0"] = layout_turns(f"{name}, lane 0", one, args.rounds)

    if "144" in args.inputs:
        eng = cs.dem_engine(dev, code=cs.DEM144_CODE, rounds=cs.DEM144_ROUNDS,
                            osd=OSDConfig(order=cs.PH_ORDER))
        syn, llrs, hard, _ = cs.out_of_image(eng, cs.OSDE_WIDE_P, 7, cs.OSDE_WIDE_LANES)
        both("[[144]] DEM, phase 14c's lanes", prepared(eng.osd, syn, llrs, hard))
        del eng
        torch.cuda.empty_cache()
    if "288" in args.inputs:
        with tempfile.TemporaryDirectory() as tmp:
            eng = preset_engine(dev, cs.DEM288_CODE, cs.DEM288_P, tmp)
        syn, llrs, hard, _ = cs.out_of_image(eng, cs.DEM288_P, 7, cs.OSDE_288_LANES)
        both("[[288]] DEM, phase 23b's lanes", prepared(eng.osd, syn, llrs, hard))
        syn, llrs, hard = cs.dem_failures(eng, cs.DEM288_P, 7)
        osd = eng.osd
        a = prepared(osd, syn, llrs, hard)
        over = torch.nonzero(osd_factored_cuda.eliminate_factored_cuda(
            a[0], a[1], osd.Hc, osd.h_rank, osd.max_cols)[3]).flatten()
        if len(over):
            both(f"[[288]] DEM, the {len(over)} BP failures past the budget",
                 (a[0][over], a[1][over], *a[2:]))
        del eng, osd
        torch.cuda.empty_cache()
    if "st288" in args.inputs:
        from qldpc_tpu_torch.codes import get_code
        from qldpc_tpu_torch.noise.spacetime import space_time_matrix

        eng = cs.st_engine(dev, code=cs.DEM288_CODE, rounds=cs.ST288_ROUNDS)
        _, syn, priors = eng._sample(rng.key(3), 0.008)
        res = eng.bp(syn, priors)
        fail = ~res.converged
        H = space_time_matrix(get_code(cs.DEM288_CODE).Hx, cs.ST288_ROUNDS)
        osd = OSDDecoder(H, OSDConfig(order=cs.PH_ORDER)).to(dev)
        k = args.st_lanes
        both("[[288]] space-time T = 18, BP failures, no b-exit",
             prepared(osd, syn[fail][:k], res.llrs[fail][:k], res.hard[fail][:k], False))
    return out


def card(args) -> int:
    if not torch.cuda.is_available():
        print("probe_k4g: no CUDA device", file=sys.stderr)
        return 1
    import tempfile

    from qldpc_tpu_torch.decoders import OSDConfig, OSDDecoder
    from qldpc_tpu_torch.utils import rng

    dev = torch.device("cuda:0")
    card_line = cs.card()
    log(card_line)
    if args.layouts:
        t0 = time.perf_counter()
        otc._GLOBAL_LIB.lib
        log(f"built in {time.perf_counter() - t0:.1f} s")
        summary = layouts(args, dev, card_line)
        if args.out:
            Path(args.out).mkdir(parents=True, exist_ok=True)
            (Path(args.out) / "probe_k4g_layouts.json").write_text(json.dumps(summary, indent=1))
        log(card_line)
        return 0
    probe_lib = probe_library()
    variants = {f"threads{t}": probe_library(t, probe=False) for t in args.threads_variants}
    old_lib = None
    if args.old_csrc:
        old_lib = KernelLibrary(str(Path(args.old_csrc).resolve() / "gf2_transform_elim_global.cu"),
                                {"gf2_transform_elim_global_launch": OLD_LAUNCH})
    t0 = time.perf_counter()
    libs = (otc._GLOBAL_LIB, probe_lib, *variants.values(), *([old_lib] if old_lib else []))
    for lib in libs:
        lib.lib
        log(f"{lib.source.name}: " + " ".join(
            ln.strip() for ln in lib.build_log.splitlines() if "registers" in ln or "spill" in ln))
    log(f"built in {time.perf_counter() - t0:.1f} s")
    only = tuple(args.widths) if args.widths else None
    summary = {"card": card_line, "inputs": {}}
    if "144" in args.inputs:
        eng = cs.dem_engine(dev, code=cs.DEM144_CODE, rounds=cs.DEM144_ROUNDS,
                            osd=OSDConfig(order=cs.PH_ORDER))
        syn, llrs, hard, _ = cs.out_of_image(eng, cs.OSDE_WIDE_P, 7, cs.OSDE_WIDE_LANES)
        summary["inputs"]["144"] = probe_input("[[144]] DEM, phase 14c's lanes",
                                               prepared(eng.osd, syn, llrs, hard),
                                               probe_lib, old_lib, args.reps, only, variants)
        if args.traffic:
            summary["traffic_144"] = [past_budget(eng, 0.002)]
            log(f"  [[144]] DEM traffic: {summary['traffic_144']}")
        del eng
        torch.cuda.empty_cache()
    if "288" in args.inputs:
        with tempfile.TemporaryDirectory() as tmp:
            eng = preset_engine(dev, cs.DEM288_CODE, cs.DEM288_P, tmp)
        syn, llrs, hard, _ = cs.out_of_image(eng, cs.DEM288_P, 7, cs.OSDE_288_LANES)
        summary["inputs"]["288"] = probe_input("[[288]] DEM, phase 23b's lanes",
                                               prepared(eng.osd, syn, llrs, hard),
                                               probe_lib, old_lib, args.reps, only, variants)
        if args.traffic:
            summary["traffic_288"] = [past_budget(eng, p) for p in (0.0015, 0.002, 0.003)]
            for rec in summary["traffic_288"]:
                log(f"  [[288]] DEM traffic: {rec}")
        del eng
        torch.cuda.empty_cache()
    if "st288" in args.inputs:
        from qldpc_tpu_torch.codes import get_code
        from qldpc_tpu_torch.noise.spacetime import space_time_matrix

        eng = cs.st_engine(dev, code=cs.DEM288_CODE, rounds=cs.ST288_ROUNDS)
        _, syn, priors = eng._sample(rng.key(3), 0.008)
        res = eng.bp(syn, priors)
        fail = ~res.converged
        H = space_time_matrix(get_code(cs.DEM288_CODE).Hx, cs.ST288_ROUNDS)
        osd = OSDDecoder(H, OSDConfig(order=cs.PH_ORDER)).to(dev)
        k = args.st_lanes
        summary["inputs"]["st288"] = probe_input(
            "[[288]] space-time T = 18, BP failures, no b-exit",
            prepared(osd, syn[fail][:k], res.llrs[fail][:k], res.hard[fail][:k], False),
            probe_lib, old_lib, args.reps, only, variants)
    if "wide" in args.inputs:
        for m, n, dependent in cs.WIDE_SIZES:
            Hc = cs.synthetic_wide(m, n, dependent, m)
            order, resid = cs.synthetic_lanes(Hc, m, 2, 5)
            args_w = (torch.from_numpy(order).to(dev), torch.from_numpy(resid).to(dev),
                      torch.from_numpy(Hc).to(dev), m - dependent, True)
            summary["inputs"][f"wide{m}"] = probe_input(
                f"synthetic {m} x {n}, 2 lanes", args_w, probe_lib, old_lib,
                args.reps, only, variants)
            del args_w
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "probe_k4g.json").write_text(json.dumps(summary, indent=1))
    log(card_line)
    return 0


def count_walk(order, b, Hc, h_rank: int, b_exit: bool) -> dict:
    """The plain elimination, one lane, counting per panel what K4g's design
    reads: whether it pivots, the rows at or below the rank, the list (those
    holding a bit and the 32 from the rank) and the rows above the rank
    holding a panel bit."""
    m, mw = b.shape[0], Hc.shape[1]
    T = otc._identity(1, m, mw, "cpu")[0]
    bb = b.to(torch.int32).clone()
    rank, n = 0, order.shape[0]
    rows = torch.arange(m)
    c = dict(panels=0, no_pivot=0, below=0, listed=0, above_bit=0, pivots=0, last_col=-1)
    for col0 in range(0, n, 32):
        if rank >= h_rank or (b_exit and not bool(bb[rank:].any())):
            break
        W = otc.column_bits(T[None], Hc, order[None, col0:col0 + 32])[0]  # (m, J)
        held = W.any(dim=1)
        c["panels"] += 1
        if not bool(held[rank:].any()):
            c["no_pivot"] += 1
            continue
        c["below"] += m - rank
        c["listed"] += int(held[rank:].sum()) + int(((~held[rank:]) & (rows[rank:] < rank + 32)).sum())
        c["above_bit"] += int(held[:rank].sum())
        A = torch.cat([T, W, bb[:, None]], dim=1)
        for j in range(W.shape[1]):
            cand = (A[:, mw + j] != 0) & (rows >= rank)
            if not bool(cand.any()):
                continue
            p = int(cand.nonzero()[0])
            A[[p, rank]] = A[[rank, p]]
            elim = (A[:, mw + j] != 0) & (rows != rank)
            A[elim] ^= A[rank]
            rank += 1
            c["pivots"] += 1
            c["last_col"] = col0 + j
        T, bb = A[:, :mw].contiguous(), A[:, -1].contiguous()
    pp = max(c["panels"] - c["no_pivot"], 1)
    return dict(columns=c["last_col"] + 1, panels=c["panels"], no_pivot=c["no_pivot"],
                pivots=c["pivots"], rank=rank, below_per_pivot_panel=c["below"] / pp,
                list_per_pivot_panel=c["listed"] / pp, above_bit_per_pivot_panel=c["above_bit"] / pp)


def count_cpu(args) -> int:
    from qldpc_tpu_torch.decoders import OSDConfig

    torch.set_num_threads(args.threads)
    rounds = {"[[144, 12, 12]]": 12, "[[288, 12, 18]]": 18}[args.code]
    t0 = time.perf_counter()
    eng = cs.dem_engine("cpu", batch=args.batch, code=args.code, rounds=rounds,
                        osd=OSDConfig(order=0))
    syn, llrs, hard, outside = cs.out_of_image(eng, args.p, 7, args.lanes)
    log(f"{args.code} DEM on the CPU: {eng.m_checks} x {eng.n_vars}, rank {eng.osd.h_rank}, "
        f"{len(syn)} out-of-image lanes of a batch of {args.batch} at p = {args.p} "
        f"({time.perf_counter() - t0:.1f} s); all outside: {bool(outside.all())}")
    order, resid, Hc, h_rank, _ = prepared(eng.osd, syn, llrs, hard)
    recs = []
    for s in range(len(syn)):
        t0 = time.perf_counter()
        rec = count_walk(order[s], resid[s], Hc, h_rank, True)
        recs.append(rec)
        log(f"  lane {s}: {json.dumps(rec)} ({time.perf_counter() - t0:.1f} s)")
    keys = [k for k in recs[0]]
    log("  mean: " + json.dumps({k: float(np.mean([r[k] for r in recs])) for k in keys}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", help="an earlier tree's qldpc_tpu_torch/ops/csrc")
    ap.add_argument("--inputs", nargs="+", default=["144", "288", "st288"])
    ap.add_argument("--widths", nargs="+", type=int, help="cluster widths (default 1-16)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--threads-variants", nargs="*", type=int, default=[512],
                    help="block sizes of extra uninstrumented builds timed at every shape")
    ap.add_argument("--st-lanes", type=int, default=32)
    ap.add_argument("--traffic", action="store_true")
    ap.add_argument("--layouts", action="store_true",
                    help="the shared layout against the spilled one, in turns, instead")
    ap.add_argument("--rounds", type=int, default=3, help="--layouts: rounds of turns")
    ap.add_argument("--out", default="")
    ap.add_argument("--count-cpu", action="store_true")
    ap.add_argument("--code", default="[[144, 12, 12]]")
    ap.add_argument("--p", type=float, default=0.002)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    return count_cpu(args) if args.count_cpu else card(args)


if __name__ == "__main__":
    sys.exit(main())
