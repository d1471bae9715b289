"""Plain flooding sum-product BP in float32.

Per iteration every check sends each of its variables

    R = 2 atanh(clip(s * prod_{others} tanh(Q / 2), +-tanh_clip))

(s = +1 or -1 by the syndrome bit, the product over the check's other
variables), each variable's posterior is the sum of its R, in the order of
its checks, plus its prior; the hard decision is posterior < 0, and a
sample stops, keeping that iteration's posterior, hard decision and
iteration index, once its hard decision reproduces its syndrome. The next
variable-to-check message is the posterior less the check's own R. A
sample that never stops reports the last iteration, ``max_iter - 1``.

Where BP does not converge it wanders, and any change in the rounding of a
sum is amplified over the iterations until the posteriors share little
more than their sign pattern's statistics. So that a comparison of
posteriors means something, the reference rounds as the engines under
test define their float32 BP: every sum is a left fold in slot order, and
the leave-one-out product is, for a check of up to ``LARGE_DC`` slots,
the product of the slots before it times the product, folded from the
right, of the slots after it, and for a larger one the exp of the fold of
log |tanh| less the slot's own, with the signs apart.

With ``messages=torch.bfloat16`` every message is rounded to bfloat16
where it is kept between the passes (the check-to-variable R, the
variable-to-check Q) and all arithmetic stays float32, as the program's
bf16 paths round: the control of a path without a lower precision of
its own.
"""

from __future__ import annotations

import numpy as np
import torch

LARGE_DC = 16


class Graph:
    """H's edges in a padded check-slot layout (each check's variables in
    ascending order, then padding), slot-major so that a fold over a
    check's slots reads contiguous memory, on ``device``."""

    def __init__(self, H: np.ndarray, device):
        H = np.asarray(H) % 2
        m, n = H.shape
        checks, vars_ = np.nonzero(H)
        deg = np.bincount(checks, minlength=m)
        self.m, self.n, self.edges = m, n, int(checks.size)
        self.dc = int(deg.max())
        slot = np.arange(checks.size) - np.repeat(np.cumsum(deg) - deg, deg)
        var_of_slot = np.full((self.dc, m), n, np.int64)  # n: no variable
        var_of_slot[slot, checks] = vars_
        flat = slot * m + checks
        dv = np.bincount(vars_, minlength=n)
        by_var = np.argsort(vars_, kind="stable")  # each variable's checks, ascending
        vslot = np.arange(vars_.size) - np.repeat(np.cumsum(dv) - dv, dv)
        slots_of_var = np.full((int(dv.max()), n), m * self.dc, np.int64)  # a zero slot
        slots_of_var[vslot, vars_[by_var]] = flat[by_var]
        self.var_of_slot = torch.from_numpy(var_of_slot).to(device)
        self.real = self.var_of_slot < n
        self.slots_of_var = torch.from_numpy(slots_of_var).to(device)

    def parity(self, bits: torch.Tensor) -> torch.Tensor:
        """(B, n) 0/1 -> (B, m) int32 syndromes."""
        padded = torch.nn.functional.pad(bits.to(torch.int32), (0, 1))
        return padded[:, self.var_of_slot].sum(1, dtype=torch.int32) % 2


def _fold(x: torch.Tensor) -> torch.Tensor:
    """Left fold over axis 1."""
    acc = x[:, 0]
    for j in range(1, x.shape[1]):
        acc = acc + x[:, j]
    return acc


def _leave_one_out(t: torch.Tensor) -> torch.Tensor:
    """(A, k, m) -> (A, k, m): for slot j, (t_0 ... t_{j-1}) * (t_{k-1} ... t_{j+1})."""
    k = t.shape[1]
    right = [None] * k
    right[k - 1] = t[:, k - 1]
    for j in range(k - 2, -1, -1):
        right[j] = right[j + 1] * t[:, j]
    out, left = [], None
    for j in range(k):
        after = right[j + 1] if j + 1 < k else None
        if left is None:
            out.append(after if after is not None else torch.ones_like(t[:, j]))
        else:
            out.append(left if after is None else left * after)
        left = t[:, j] if left is None else left * t[:, j]
    return torch.stack(out, dim=1)


def check_messages(g: Graph, Q: torch.Tensor, sgn: torch.Tensor, clip: float) -> torch.Tensor:
    """R (A, dc, m) from Q (A, dc, m); ``sgn`` (A, 1, m) the syndrome signs."""
    one = torch.ones((), dtype=Q.dtype, device=Q.device)
    t = torch.where(g.real, torch.tanh(Q * 0.5), one)
    if g.dc > LARGE_DC:
        s = torch.where(t >= 0, one, -one)
        neg = (t < 0).sum(1, keepdim=True, dtype=torch.int32)
        parity = (1 - 2 * (neg % 2)).to(Q.dtype)
        logt = torch.log(torch.clamp(t.abs(), min=1e-15))
        others = torch.exp(_fold(logt)[:, None] - logt) * parity * s
    else:
        others = _leave_one_out(t)
    return 2.0 * torch.atanh(torch.clamp(others * sgn, -clip, clip))


def decode(graph: Graph, syndromes: torch.Tensor, prior_llr: torch.Tensor, max_iter: int,
           tanh_clip: float, chunk: int = 256, messages: torch.dtype = torch.float32):
    """(posteriors (B, n) float32, converged (B,), iterations (B,) int32,
    hard (B, n) int8) of every sample, ``chunk`` samples at a time."""
    outs = [_decode(graph, syndromes[s:s + chunk], prior_llr, max_iter, tanh_clip, messages)
            for s in range(0, syndromes.shape[0], chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _decode(g: Graph, syn: torch.Tensor, prior: torch.Tensor, max_iter: int, clip: float,
            messages: torch.dtype):
    def kept(x):  # a message as it is kept between the passes
        return x.to(messages).to(torch.float32)

    B, dev = syn.shape[0], syn.device
    syn = syn.to(torch.int32)
    prior = prior.to(device=dev, dtype=torch.float32)
    sgn = (1 - 2 * syn).to(torch.float32)[:, None, :]
    post = prior.expand(B, g.n).clone()
    hard = torch.zeros((B, g.n), dtype=torch.int8, device=dev)
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), max_iter - 1, dtype=torch.int32, device=dev)
    Q = kept(torch.cat([prior, prior.new_zeros(1)])[g.var_of_slot].expand(B, g.dc, g.m).clone())
    live = torch.arange(B, device=dev)
    for it in range(max_iter):
        R = kept(check_messages(g, Q, sgn[live], clip))
        flat = torch.cat([R.reshape(len(live), -1), R.new_zeros(len(live), 1)], dim=1)
        vals = _fold(flat[:, g.slots_of_var]) + prior
        h = (vals < 0).to(torch.int8)
        ok = (g.parity(h) == syn[live]).all(-1)
        post[live], hard[live], iters[live], conv[live] = vals, h, it, ok
        Q = kept(torch.cat([vals, vals.new_zeros(len(live), 1)], dim=1)[:, g.var_of_slot] - R)
        keep = ~ok
        live, Q = live[keep], Q[keep]
        if not len(live):
            break
    return post, conv, iters, hard
