"""Monte-Carlo logical-error-rate engine, on one device or a process mesh.

Port of qldpc_tpu/mc/engine.py: per batch, counter-mode RNG draws the
errors, the syndrome is computed, BP decodes, OSD-0 runs on the samples BP
did not converge, and every sample is classified into the counters (on a
card by one kernel, K9: ``ops/classify_cuda.py``).

The batch keys are the JAX engine's: ``fold_in(fold_in(key(seed),
hash(p) % 2**31), b)`` for batch b, with global sample ids starting at 0,
and a sweep uses ``seed + i`` for rate i. So at the same seed the port draws
the same errors as the JAX engine and its counters can be compared with the
JAX engine's bit for bit.

All BP failures, up to the OSD capacity ``k_osd``, are compacted into one
OSD call; failures beyond it keep the BP output and are counted in
``osd_overflow``. This gives the counters of the JAX engine's lax.cond tier
ladder, which needs no counterpart on the GPU.

The space-time channel decodes T rounds of the code (``EngineConfig.n_rounds``,
0 meaning the code's distance) with ``SpaceTimeBPDecoder`` on the base code's
tables and OSD-0 on the materialized ``H_st``; the classification folds the
data rounds into the net flip of each qubit, as the JAX engine does.

With ``rescue_iters`` set, BP(rescue_iters) decodes the whole batch and
BP(max_iter) then decodes its failures alone, compacted as the OSD's are:
BP is deterministic per sample, so the counters equal a single long run's.
``run_rate`` resumes from a batch with running counters and reports each
batch (``on_batch``), which ``CheckpointManager`` drives.

Several devices run one process each (``torchrun``, or ``parallel.smoke``),
placed on a ``parallel.Mesh``. Each process of a batch group decodes
``batch_size / batch_shards`` samples of every batch, drawn from the one
global stream at ``base = batch_rank * local_batch``, with the OSD capacity
sized from its own slice as the JAX engine sizes it per shard; its counters
accumulate on its device over a rate and are summed over the group once per
rate (after every batch only for ``on_batch``). The counters are therefore
those of one process at every world size that divides the batch. On a 2-D
mesh ``run_rates_sharded`` splits the rate grid over the rate groups.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import ClassVar

import numpy as np
import torch

from qldpc_tpu_torch.decoders.bp import BPConfig, BPDecoder, BPResult
from qldpc_tpu_torch.decoders.osd import OSDConfig, OSDDecoder
from qldpc_tpu_torch.decoders.spacetime_bp import SpaceTimeBPDecoder
from qldpc_tpu_torch.mc.metrics import (
    HIST_BINS,
    Counters,
    counters_to_dict,
    zeros_counters,
)
from qldpc_tpu_torch.noise import channels as ch
from qldpc_tpu_torch.noise import spacetime as st
from qldpc_tpu_torch.ops import classify_cuda
from qldpc_tpu_torch.parallel.mesh import Mesh, make_mesh
from qldpc_tpu_torch.utils import profiling, rng
from qldpc_tpu_torch.utils.profiling import count, span

__all__ = ["EngineConfig", "MonteCarloEngine", "SweepResult"]

_CHANNELS = ("code-capacity", "doubled", "phenomenological", "space-time")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    bp: BPConfig = BPConfig()
    osd: OSDConfig | None = OSDConfig()  # None = BP-only (fault => logical error)
    channel: str = "code-capacity"  # | "doubled" | "phenomenological" | "space-time"
    basis: str = "x"
    n_rounds: int = 0  # space-time rounds; 0 => code.distance
    syndrome_flip_rate: float | None = None  # phenomenological and
    # space-time measurement-error rate q (None => p)
    batch_size: int = 4096
    osd_fraction: float = 1.0  # OSD capacity as a fraction of the batch;
    # failures beyond it keep the BP output and count as osd_overflow
    rescue_iters: int = 0  # >0: BP(rescue_iters) on the whole batch, then
    # BP(bp.max_iter) on its failures alone; the counters do not change

    _channels: ClassVar[tuple[str, ...]] = _CHANNELS

    def __post_init__(self):
        if self.channel not in self._channels:
            raise ValueError(f"unknown channel {self.channel!r}")
        if self.basis not in ("x", "z"):
            raise ValueError(f"unknown basis {self.basis!r}")
        if self.batch_size < 1:
            raise ValueError("batch_size must be positive")
        if self.n_rounds < 0:
            raise ValueError("n_rounds must be >= 0")
        if self.rescue_iters < 0:
            raise ValueError("rescue_iters must be >= 0")
        if self.channel == "space-time" and self.bp.schedule == "layered":
            # the JAX engine's fallback to BPDecoder(H_st) raises there too
            raise ValueError(
                "the layered schedule requires a check-regular graph; the "
                "space-time matrix is not one"
            )


@dataclasses.dataclass
class SweepResult:
    code_name: str
    error_rates: list[float]
    per_rate: list[dict]  # counters_to_dict output per error rate
    wall_time_s: float = 0.0
    throughput: float = 0.0  # decoded syndromes / s

    def curve(self, key: str) -> np.ndarray:
        return np.array([r[key] for r in self.per_rate])


def engine_device(device) -> torch.device:
    """The one device an engine runs on. A CUDA device needs a card: without
    one this raises rather than carrying on on the CPU."""
    if isinstance(device, (list, tuple)):
        raise NotImplementedError(
            "an engine runs on one device: for several, run one process per "
            "device (torchrun) and pass mesh=qldpc_tpu_torch.parallel.make_mesh() "
            "with device=parallel.rank_device()"
        )
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the engine runs on {device} by default, but torch finds no CUDA "
            "device; pass device='cpu' to run the plain torch versions on the CPU"
        )
    return device


class MonteCarloEngine:
    """Batched LER estimation for one code and decoder configuration on one
    device: the card (``"cuda"``, the default, or ``"cuda:1"``), or
    ``"cpu"`` when asked for. ``mesh`` places this process in a process grid
    (default: ``parallel.make_mesh()``, the whole group, or this process
    alone)."""

    def __init__(self, code, config: EngineConfig, device="cuda", mesh: Mesh | None = None):
        self.code = code
        H = code.Hx if config.basis == "x" else code.Hz
        L = code.Lx if config.basis == "x" else code.Lz
        n_rounds, H_dec = 0, H
        if config.channel == "space-time":
            n_rounds = config.n_rounds or max(code.distance, 1)
            H_dec = st.space_time_matrix(H, n_rounds)
        # space-time's n*T + m*T variables are its draws
        draws = H_dec.shape[1] + (H_dec.shape[0] if config.channel == "phenomenological" else 0)
        self._set_problem(config, device, mesh, H, H_dec, L, n_qubits=H.shape[1],
                          distance=code.distance, n_rounds=n_rounds, draws=draws)
        self._Hf = torch.tensor(np.asarray(H_dec) % 2, dtype=torch.float32, device=self.device)
        if n_rounds:
            self._H_space = torch.tensor(np.asarray(H) % 2, dtype=torch.float32,
                                         device=self.device)

    def _set_problem(self, config: EngineConfig, device, mesh: Mesh | None, H_bp, H_dec, L, *,
                     n_qubits: int, distance: int, n_rounds: int, draws: int) -> None:
        """Everything the batch loop reads of a decoding problem, for every
        engine: BP decodes ``H_bp`` (space-time: T rounds of it), OSD and the
        classification ``H_dec``, and a sample takes ``draws`` uniforms. A
        batch past the counter space is refused before anything is built."""
        self.device = engine_device(device)
        self.config = config
        self._check_counter_space(draws)
        self._shard(config, mesh)
        self.n_qubits, self.distance, self.n_rounds = n_qubits, distance, n_rounds
        self.m_checks, self.n_vars = H_dec.shape
        self.bp, self.bp_short = self._bp_decoders(H_bp)
        self.osd = (
            OSDDecoder(H_dec, config.osd).to(self.device)
            if config.osd is not None else None
        )
        self._Lf = torch.tensor(np.asarray(L) % 2, dtype=torch.float32, device=self.device)
        self._k9 = self._classify_tables(H_dec, L, n_qubits, n_rounds)

    def _shard(self, config: EngineConfig, mesh: Mesh | None) -> None:
        """This process's slice of every batch: ``local_batch`` samples from
        global sample id ``base``, and an OSD capacity sized from them."""
        self.mesh = mesh if mesh is not None else make_mesh()
        if config.batch_size % self.mesh.batch_shards:
            raise ValueError(
                f"batch_size {config.batch_size} must divide evenly across the "
                f"{self.mesh.batch_shards} processes of a batch group"
            )
        self.local_batch = config.batch_size // self.mesh.batch_shards
        self.base = self.mesh.batch_rank * self.local_batch
        self.k_osd = max(1, int(round(self.local_batch * config.osd_fraction)))
        self._all_valid = torch.ones(self.local_batch, dtype=torch.bool, device=self.device)

    def _bp_decoders(self, H):
        """The BP decoder, and the short one of ``rescue_iters`` (or None):
        space-time decodes T rounds of the base matrix, the other channels
        the matrix itself."""
        cfg = self.config

        def make(bp_cfg):
            if cfg.channel == "space-time":
                return SpaceTimeBPDecoder(H, self.n_rounds, bp_cfg).to(self.device)
            return BPDecoder(H, bp_cfg).to(self.device)

        short = None
        if 0 < cfg.rescue_iters < cfg.bp.max_iter:
            short = make(dataclasses.replace(cfg.bp, max_iter=cfg.rescue_iters))
        return make(cfg.bp), short

    def _classify_tables(self, H_dec, L, n_qubits: int, n_rounds: int):
        """K9's tables of the decoding problem on a card; None on the CPU,
        which classifies with the plain version."""
        if self.device.type != "cuda":
            return None
        return classify_cuda.classify_tables(H_dec, L, n_qubits, n_rounds, self.distance,
                                             self.device)

    def _check_counter_space(self, stride: int) -> None:
        """One batch draws ``batch_size * ceil(stride / 2)`` counter pairs;
        past 2^32 the streams would wrap and repeat across samples."""
        if self.config.batch_size * ((stride + 1) // 2) >= 2**32:
            raise ValueError(
                f"batch_size x {(stride + 1) // 2} counter pairs per sample "
                "exceeds the 2^32 counter space of one batch; use a smaller "
                "batch_size"
            )

    # ------------------------------------------------------------ one batch
    def _sample(self, key, p: float):
        """Channel sampling; returns (errors, syndromes, priors)."""
        cfg, dev = self.config, self.device
        n, B, base = self.n_vars, self.local_batch, self.base
        if cfg.channel == "code-capacity":
            errors = ch.code_capacity(key, base, p, B, n, device=dev)
            syn = ch.syndrome_of(self._Hf, errors)
        elif cfg.channel == "doubled":
            errors = ch.doubled_channel(key, base, p, B, n, device=dev)
            syn = ch.syndrome_of(self._Hf, errors)
        elif cfg.channel == "phenomenological":
            q = p if cfg.syndrome_flip_rate is None else cfg.syndrome_flip_rate
            errors, flips = ch.phenomenological(
                key, base, p, B, n, self.m_checks, q=q, device=dev
            )
            syn = (ch.syndrome_of(self._Hf, errors) + flips) % 2
        else:
            q = p if cfg.syndrome_flip_rate is None else cfg.syndrome_flip_rate
            errors, syn = st.sample_space_time_counters(
                key, base, self._H_space, p, B, self.n_rounds, q=q, device=dev
            )
            m = self._H_space.shape[0]
            priors = st.space_time_prior_llr(self.n_qubits, m, self.n_rounds, p,
                                             q=q, device=dev)
            return errors, syn, priors
        # the other channels are decoded with the plain log((1-p)/p) prior
        priors = ch.uniform_prior_llr(n, p, device=dev)
        return errors, syn, priors

    def _syndrome(self, errors):
        """(B, n) -> (B, m) int8 syndromes, for the classification."""
        return ch.syndrome_of(self._Hf, errors)

    def _decode(self, syn, priors, alpha: float) -> BPResult:
        """BP, or with ``rescue_iters`` BP(short) on the batch and BP(max_iter)
        from scratch on its failures, compacted to the front as
        ``_post_process`` compacts OSD's, and merged back."""
        if self.bp_short is None:
            return self.bp(syn, priors, alpha=alpha)
        r1 = self.bp_short(syn, priors, alpha=alpha)
        sel = torch.nonzero(~r1.converged).flatten()
        count("host_syncs")
        if not len(sel):
            return r1
        r2 = self.bp(syn[sel], priors, alpha=alpha)
        merged = [x.clone() for x in r1]
        for whole, part in zip(merged, r2):
            whole[sel] = part
        return BPResult(*merged)

    def _post_process(self, syn, bp_res: BPResult):
        """OSD-0 on the first ``k_osd`` BP failures; returns (final, overflow)."""
        failed = ~bp_res.converged
        n_fail = int(failed.sum())
        count("host_syncs")
        final = bp_res.hard
        if n_fail:
            sel = torch.nonzero(failed).flatten()[: self.k_osd]
            count("host_syncs")
            final = final.clone()
            final[sel] = self.osd(syn[sel], bp_res.llrs[sel], bp_res.hard[sel])
        return final, max(n_fail - self.k_osd, 0)

    def _classify(self, errors, final, syn, bp_res: BPResult, valid, *,
                  overflow: int = 0) -> Counters:
        """Outcome taxonomy of the JAX engine's ``_classify``: K9 on a card
        (``ops/classify_cuda.py``), the plain version on the CPU. ``valid``
        is the (B,) bool mask of the samples that count; ``overflow`` is the
        batch's ``osd_overflow``."""
        if self.device.type != "cuda":
            return self._classify_plain(errors, final, syn, bp_res, valid, overflow=overflow)
        # K9 folds the data rounds: the fold's span is its launch
        with span("classify.fold") if self.n_rounds else contextlib.nullcontext():
            return classify_cuda.classify_cuda(
                self._k9, errors, final, syn, bp_res.converged, bp_res.iterations, valid,
                overflow, bp_only=self.osd is None)

    def _classify_plain(self, errors, final, syn, bp_res: BPResult, valid, *,
                        overflow: int = 0) -> Counters:
        """``_classify`` in torch, on any device: the CPU's path and K9's
        reference."""
        conv = bp_res.converged
        errors_i = errors.to(torch.int32)
        final_i = final.to(torch.int32)
        residual = (errors_i + final_i) % 2
        if self.n_rounds:
            # the logical check and both weights see the net flip per qubit
            with span("classify.fold"):
                residual = st.fold_data_correction(residual, self.n_qubits, self.n_rounds)
                err_weight = st.fold_data_correction(
                    errors_i, self.n_qubits, self.n_rounds).sum(-1)
        else:
            err_weight = errors_i.sum(-1)
        logical_vec = torch.remainder(residual.to(torch.float32) @ self._Lf.T, 2.0)
        res_weight = residual.sum(-1)

        vec_logical = (logical_vec != 0).any(-1)
        logical = vec_logical if self.osd is not None else vec_logical | ~conv
        mismatch = (final_i != errors_i).any(-1)
        sol_valid = (self._syndrome(final) == syn.to(torch.int8)).all(-1)
        # strict weight < d/2 in integers (2w < d), as the reference
        low_weight = (2 * err_weight) < self.distance
        degenerate = ~logical & mismatch
        osd_used = ~conv if self.osd is not None else torch.zeros_like(conv)

        cnt = lambda mask: (mask & valid).sum(dtype=torch.int64)
        w = res_weight.clamp(0, HIST_BINS - 1).long()

        def hist(mask):
            h = torch.zeros(HIST_BINS, dtype=torch.int64, device=self.device)
            return h.index_add_(0, w, (mask & valid).to(torch.int64))

        return Counters(
            trials=valid.sum(dtype=torch.int64),
            logical_errors=cnt(logical),
            residual_logicals=cnt(vec_logical),
            bp_converged=cnt(conv),
            bp_faults=cnt(~conv),
            osd_invocations=cnt(osd_used),
            miscorrected=cnt(logical & low_weight),
            incorrectable=cnt(logical & ~low_weight),
            degeneracies=cnt(degenerate),
            valid_degenerate=cnt(degenerate & sol_valid),
            osd_and_logical=cnt(logical & ~conv),
            osd_overflow=torch.tensor(overflow, dtype=torch.int64, device=self.device),
            sum_iterations=torch.where(
                valid, bp_res.iterations, 0
            ).sum(dtype=torch.int64),
            hist_bp=hist(degenerate & conv),
            hist_osd=hist(degenerate & ~conv),
            hist_bp_error=hist(logical & conv),
            hist_osd_error=hist(logical & ~conv),
        )

    def run_batch(self, key, p: float, n_valid: int, alpha: float) -> Counters:
        """Sample, decode and classify this process's slice of one batch;
        the batch's first ``n_valid`` samples count. Each stage runs in its
        span (``qldpc.sample``, ``.bp``, ``.osd``, ``.classify``)."""
        with span("sample"):
            errors, syn, priors = self._sample(key, p)
        with span("bp"):
            bp_res = self._decode(syn, priors, alpha)
        if self.osd is not None:
            with span("osd"):
                final, overflow = self._post_process(syn, bp_res)
        else:
            final, overflow = bp_res.hard, 0
        with span("classify"):
            k = n_valid - self.base  # the samples of this slice that count
            valid = self._all_valid if k >= self.local_batch else (
                torch.arange(self.local_batch, device=self.device) < k)
            if self.device.type != "cuda":
                count("host_syncs")  # the plain version's copy of the overflow to the device
            # without an overflow, the five-argument call that the benchmark's
            # fault-injection tests wrap
            extra = {"overflow": overflow} if overflow else {}
            return self._classify(errors, final, syn, bp_res, valid, **extra)

    # ------------------------------------------------------------------ run
    def _local_counters(self, p: float, trials: int, seed: int, alpha: float | None,
                        start_batch: int = 0, reduce=None, each=None) -> Counters:
        """This process's counters over batches ``start_batch..``, summed on
        its device. With ``each``, every batch also ends with ``reduce(local)``
        of the running sum, which ``each(b, n_batches, reduced)`` then sees.
        Each batch is a ``profiling.batch`` scope (``each`` runs after it)."""
        B = self.config.batch_size
        a32 = float(np.float32(self.config.bp.alpha if alpha is None else alpha))
        kp = rng.fold_in(rng.key(seed), hash(p) % (2**31))
        local = zeros_counters(self.device)
        n_batches = -(-trials // B)
        for b in range(start_batch, n_batches):
            n_valid = min(B, trials - b * B)
            with profiling.batch():
                with span("key"):
                    key = rng.fold_in(kp, b)
                counters = self.run_batch(key, p, n_valid, a32)
                with span("counters"):
                    local = local + counters
                    if each is not None:
                        reduced = reduce(local)
            if each is not None:
                each(b, n_batches, reduced)
        return local

    def run_rate(self, p: float, trials: int, seed: int = 0, start_batch: int = 0,
                 init: Counters | None = None, on_batch=None,
                 alpha: float | None = None) -> Counters:
        """Accumulate ``trials`` samples at one error rate; the counters of
        the whole batch group, on the CPU, on every process of it.

        Batch b is keyed ``fold_in(fold_in(key(seed), hash(p) % 2**31), b)``,
        so a run resumed at ``start_batch`` with the counters ``init`` of the
        batches before it draws what an uninterrupted run draws. ``on_batch(b,
        n_batches, total)`` gets the running counters on the CPU after each
        batch (the one place a batch waits for the card, and for the other
        processes of the group). ``alpha`` replaces the decoder's alpha for
        this rate; like the JAX engine, the decoder receives it rounded to
        float32 (which matters for float64 BP)."""
        init = (init if init is not None else zeros_counters()).to("cpu")

        def reduced(local: Counters) -> Counters:
            return init + Counters(*self.mesh.reduce_batch(local))

        if on_batch is None:
            return reduced(self._local_counters(p, trials, seed, alpha, start_batch))
        total = [init]

        def each(b, n_batches, reduced_total):
            total[0] = reduced_total
            on_batch(b, n_batches, reduced_total)

        self._local_counters(p, trials, seed, alpha, start_batch, reduced, each)
        return total[0]

    def run_rates_sharded(self, error_rates, trials: int, seed: int = 0,
                          alpha: float | None = None) -> list[Counters]:
        """Every rate's counters on every process, the rate grid split over
        the mesh's rate groups (``make_mesh(rate_shards=r)``).

        As in the JAX engine, the grid is padded to a multiple of the rate
        groups and group g takes the g-th contiguous block; rate i runs with
        seed ``seed + i``, so the counters equal ``[run_rate(p_i, trials,
        seed + i) ...]`` on any mesh. The padding's rates are dropped, so they
        are not run. On a 1-D mesh this is that sequential loop."""
        rates = [float(p) for p in error_rates]
        mesh = self.mesh
        if mesh.rate_shards == 1:
            return [self.run_rate(p, trials, seed=seed + i, alpha=alpha)
                    for i, p in enumerate(rates)]
        block = -(-len(rates) // mesh.rate_shards)
        mine = range(mesh.rate_index * block, min((mesh.rate_index + 1) * block, len(rates)))
        local = [self._local_counters(rates[i], trials, seed + i, alpha) if i in mine
                 else zeros_counters() for i in range(len(rates))]
        # one reduction over the world sums each rate over its batch group
        # and hands every process the other groups' rates
        flat = mesh.reduce_world([x for c in local for x in c])
        n = len(Counters._fields)
        return [Counters(*flat[i * n:(i + 1) * n]) for i in range(len(rates))]

    def sweep(self, error_rates, trials: int, seed: int = 0,
              checkpoint=None, verbose: bool = False) -> SweepResult:
        """LER sweep over an error-rate grid; rate i uses seed ``seed + i``.
        With a ``CheckpointManager`` each rate resumes from its last saved
        batch; without one a 2-D mesh splits the grid over its rate groups
        (``run_rates_sharded``). Only the mesh's process 0 prints."""
        t0 = time.time()
        if checkpoint is None and self.mesh.rate_shards > 1:
            runs = self.run_rates_sharded(error_rates, trials, seed)
        else:  # one rate at a time, each printed as it ends
            runs = (checkpoint.run_rate(self, float(p), trials, seed + i)
                    if checkpoint is not None else self.run_rate(float(p), trials, seed=seed + i)
                    for i, p in enumerate(error_rates))
        per_rate = []
        for p, counters in zip(error_rates, runs):
            d = counters_to_dict(counters)
            per_rate.append(d)
            if verbose and self.mesh.rank == 0:
                print(
                    f"{self.code.name} p={float(p):.5g}: ler={d['ler']:.5g} "
                    f"osd={d['osd']:.3g} iters={d['average_iterations']:.2f}"
                )
        wall = time.time() - t0
        total_trials = sum(r["trials"] for r in per_rate)
        return SweepResult(
            code_name=self.code.name,
            error_rates=[float(p) for p in error_rates],
            per_rate=per_rate,
            wall_time_s=wall,
            throughput=total_trials / max(wall, 1e-9),
        )
