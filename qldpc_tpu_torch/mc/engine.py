"""Monte-Carlo logical-error-rate engine on one device.

Port of qldpc_tpu/mc/engine.py: per batch, counter-mode RNG draws the
errors, the syndrome is computed, BP decodes, OSD-0 runs on the samples BP
did not converge, and every sample is classified into the counters.

The batch keys are the JAX engine's: ``fold_in(fold_in(key(seed),
hash(p) % 2**31), b)`` for batch b, with global sample ids starting at 0,
and a sweep uses ``seed + i`` for rate i. So at the same seed the port draws
the same errors as the JAX engine and its counters can be compared with the
JAX engine's bit for bit.

All BP failures, up to the OSD capacity ``k_osd``, are compacted into one
OSD call; failures beyond it keep the BP output and are counted in
``osd_overflow``. This gives the counters of the JAX engine's lax.cond tier
ladder, which needs no counterpart on the GPU.

Not in this slice (see ROADMAP.md): the space-time channel, rescue_iters,
checkpointing and multi-device execution.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from qldpc_tpu_torch.decoders.bp import BPConfig, BPDecoder, BPResult
from qldpc_tpu_torch.decoders.osd import OSDConfig, OSDDecoder
from qldpc_tpu_torch.mc.metrics import (
    HIST_BINS,
    Counters,
    counters_to_dict,
    zeros_counters,
)
from qldpc_tpu_torch.noise import channels as ch
from qldpc_tpu_torch.utils import rng

__all__ = ["EngineConfig", "MonteCarloEngine", "SweepResult"]

_CHANNELS = ("code-capacity", "doubled", "phenomenological")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    bp: BPConfig = BPConfig()
    osd: OSDConfig | None = OSDConfig()  # None = BP-only (fault => logical error)
    channel: str = "code-capacity"  # | "doubled" | "phenomenological"
    basis: str = "x"
    syndrome_flip_rate: float | None = None  # phenomenological q (None => p)
    batch_size: int = 4096
    osd_fraction: float = 1.0  # OSD capacity as a fraction of the batch;
    # failures beyond it keep the BP output and count as osd_overflow

    def __post_init__(self):
        if self.channel == "space-time":
            raise NotImplementedError(
                "the space-time channel is not ported yet (ROADMAP.md, queue "
                "1 item 11)"
            )
        if self.channel not in _CHANNELS:
            raise ValueError(f"unknown channel {self.channel!r}")
        if self.basis not in ("x", "z"):
            raise ValueError(f"unknown basis {self.basis!r}")
        if self.batch_size < 1:
            raise ValueError("batch_size must be positive")


@dataclasses.dataclass
class SweepResult:
    code_name: str
    error_rates: list[float]
    per_rate: list[dict]  # counters_to_dict output per error rate
    wall_time_s: float = 0.0
    throughput: float = 0.0  # decoded syndromes / s

    def curve(self, key: str) -> np.ndarray:
        return np.array([r[key] for r in self.per_rate])


class MonteCarloEngine:
    """Batched LER estimation for one code and decoder configuration on one
    explicitly named device (``"cuda"``, ``"cuda:1"``, ``"cpu"``)."""

    def __init__(self, code, config: EngineConfig, device):
        if isinstance(device, (list, tuple)):
            raise NotImplementedError(
                "multi-device execution is not ported yet (ROADMAP.md, queue "
                "1 item 13)"
            )
        self.code = code
        self.config = config
        self.device = torch.device(device)
        H = code.Hx if config.basis == "x" else code.Hz
        L = code.Lx if config.basis == "x" else code.Lz
        self.m_checks, self.n_vars = H.shape
        self.distance = code.distance
        self.bp = BPDecoder(H, config.bp).to(self.device)
        self.osd = (
            OSDDecoder(H, config.osd).to(self.device)
            if config.osd is not None else None
        )
        self._Hf = torch.tensor(np.asarray(H) % 2, dtype=torch.float32, device=self.device)
        self._Lf = torch.tensor(np.asarray(L) % 2, dtype=torch.float32, device=self.device)
        B = config.batch_size
        self.k_osd = max(1, int(round(B * config.osd_fraction)))
        stride = self.n_vars + (
            self.m_checks if config.channel == "phenomenological" else 0
        )
        if B * ((stride + 1) // 2) >= 2**32:
            raise ValueError(
                f"batch_size x {(stride + 1) // 2} counter pairs per sample "
                "exceeds the 2^32 counter space of one batch; use a smaller "
                "batch_size"
            )

    # ------------------------------------------------------------ one batch
    def _sample(self, key, p: float):
        """Channel sampling; returns (errors, syndromes, priors)."""
        cfg, dev = self.config, self.device
        n, B = self.n_vars, cfg.batch_size
        if cfg.channel == "code-capacity":
            errors = ch.code_capacity(key, 0, p, B, n, device=dev)
            syn = ch.syndrome_of(self._Hf, errors)
        elif cfg.channel == "doubled":
            errors = ch.doubled_channel(key, 0, p, B, n, device=dev)
            syn = ch.syndrome_of(self._Hf, errors)
        else:
            q = p if cfg.syndrome_flip_rate is None else cfg.syndrome_flip_rate
            errors, flips = ch.phenomenological(
                key, 0, p, B, n, self.m_checks, q=q, device=dev
            )
            syn = (ch.syndrome_of(self._Hf, errors) + flips) % 2
        # every channel is decoded with the plain log((1-p)/p) prior
        priors = ch.uniform_prior_llr(n, p, device=dev)
        return errors, syn, priors

    def _post_process(self, syn, bp_res: BPResult):
        """OSD-0 on the first ``k_osd`` BP failures; returns (final, overflow)."""
        failed = ~bp_res.converged
        n_fail = int(failed.sum())
        final = bp_res.hard
        if n_fail:
            sel = torch.nonzero(failed).flatten()[: self.k_osd]
            final = final.clone()
            final[sel] = self.osd(syn[sel], bp_res.llrs[sel], bp_res.hard[sel])
        return final, max(n_fail - self.k_osd, 0)

    def _classify(self, errors, final, syn, bp_res: BPResult, valid) -> Counters:
        """Outcome taxonomy of the JAX engine's ``_classify``."""
        conv = bp_res.converged
        errors_i = errors.to(torch.int32)
        final_i = final.to(torch.int32)
        residual = (errors_i + final_i) % 2
        logical_vec = torch.remainder(residual.to(torch.float32) @ self._Lf.T, 2.0)
        err_weight = errors_i.sum(-1)
        res_weight = residual.sum(-1)

        vec_logical = (logical_vec != 0).any(-1)
        logical = vec_logical if self.osd is not None else vec_logical | ~conv
        mismatch = (final_i != errors_i).any(-1)
        sol_valid = (ch.syndrome_of(self._Hf, final) == syn.to(torch.int8)).all(-1)
        # strict weight < d/2 in integers (2w < d), as the reference
        low_weight = (2 * err_weight) < self.distance
        degenerate = ~logical & mismatch
        osd_used = ~conv if self.osd is not None else torch.zeros_like(conv)

        cnt = lambda mask: (mask & valid).sum(dtype=torch.int64)
        w = res_weight.clamp(0, HIST_BINS - 1).long()

        def hist(mask):
            h = torch.zeros(HIST_BINS, dtype=torch.int64, device=self.device)
            return h.index_add_(0, w, (mask & valid).to(torch.int64))

        zero = torch.zeros((), dtype=torch.int64, device=self.device)
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
            osd_overflow=zero,
            sum_iterations=torch.where(
                valid, bp_res.iterations, 0
            ).sum(dtype=torch.int64),
            hist_bp=hist(degenerate & conv),
            hist_osd=hist(degenerate & ~conv),
            hist_bp_error=hist(logical & conv),
            hist_osd_error=hist(logical & ~conv),
        )

    def run_batch(self, key, p: float, n_valid: int, alpha: float) -> Counters:
        """Sample, decode and classify one batch; the first ``n_valid``
        samples count."""
        errors, syn, priors = self._sample(key, p)
        bp_res = self.bp(syn, priors, alpha=alpha)
        if self.osd is not None:
            final, overflow = self._post_process(syn, bp_res)
        else:
            final, overflow = bp_res.hard, 0
        valid = torch.arange(self.config.batch_size, device=self.device) < n_valid
        counters = self._classify(errors, final, syn, bp_res, valid)
        return counters._replace(
            osd_overflow=torch.tensor(overflow, dtype=torch.int64, device=self.device)
        )

    # ------------------------------------------------------------------ run
    def run_rate(self, p: float, trials: int, seed: int = 0) -> Counters:
        """Accumulate ``trials`` samples at one error rate; counters on the CPU.

        Like the JAX engine, the decoder receives alpha rounded to float32
        (which matters for float64 BP)."""
        B = self.config.batch_size
        a32 = float(np.float32(self.config.bp.alpha))
        kp = rng.fold_in(rng.key(seed), hash(p) % (2**31))
        total = zeros_counters(self.device)
        for b in range(-(-trials // B)):
            n_valid = min(B, trials - b * B)
            total = total + self.run_batch(rng.fold_in(kp, b), p, n_valid, a32)
        return total.to("cpu")

    def sweep(self, error_rates, trials: int, seed: int = 0,
              checkpoint=None, verbose: bool = False) -> SweepResult:
        """LER sweep over an error-rate grid; rate i uses seed ``seed + i``."""
        if checkpoint is not None:
            raise NotImplementedError(
                "checkpointed sweeps are not ported yet (ROADMAP.md, queue 1 "
                "item 7)"
            )
        t0 = time.time()
        per_rate = []
        for i, p in enumerate(error_rates):
            d = counters_to_dict(self.run_rate(float(p), trials, seed=seed + i))
            per_rate.append(d)
            if verbose:
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
