"""K2's designs, modelled lane by lane in Python, against the plain torch
version and the JAX package.

K2 (``qldpc_tpu_torch/ops/csrc/gf2_elim.cu``) moves no rows: a table of
each physical row's position (``pos << 16 | row`` a row) stands for the row
swaps of the lanes elimination, and the pivot is the least key over the
rows holding the column's bit at a position at or above the rank. Its
register instance works column-major, lane l owning columns l, l + 32, ...
(loaded from packed rows by the 32 x 32 warp transpose, or read from H's
packed columns in each sample's order); its shared instance keeps the rows.
``_k2_register_warp`` and ``_k2_shared_warp`` compute what those warps
compute, step for step, on every sample at once; the tests hold them bit
for bit against ``eliminate_rows_plain``, ``eliminate_ordered_plain`` and
the JAX ``_eliminate_lanes`` and ``_elim_kernel`` (interpret mode), on
random dense systems (many swaps), the codes, a rank-deficient system and
an early stop at ``max_rank``. The register model also asserts the design's
claim that a column before the step's never holds the pivot row's bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpc_tpu.codes import get_code, gf2
from qldpc_tpu.decoders.osd import OSDConfig as JaxOSDConfig
from qldpc_tpu.decoders.osd import OSDDecoder as JaxOSDDecoder
from qldpc_tpu.ops.osd_pallas import eliminate_pallas
from qldpc_tpu_torch.ops import osd_cuda
from qldpc_tpu_torch.ops.osd_cuda import (
    REG_INSTANCES,
    eliminate_ordered,
    eliminate_ordered_plain,
    eliminate_rows_plain,
    launch_instance,
    pack_rows,
)
from qldpc_tpu_torch.ops.osd_transform_cuda import pack_columns

torch.set_num_threads(2)

WORD = 32
U32 = 0xFFFFFFFF
NONE = 0xFFFFFFFF
_LO = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)
LANE = torch.arange(WORD)


def _u(words: torch.Tensor) -> torch.Tensor:
    return words.to(torch.int64) & U32


def _i32(words: torch.Tensor) -> torch.Tensor:
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _transpose32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The kernels' butterfly over a 32-long lane axis ``dim``: lane l's
    word holds row l on entry and column l on exit, each step taking the
    partner's word as __shfl_xor_sync gives it."""
    x = x.movedim(dim, -1)
    for k, lo in enumerate(_LO):
        s, hi = 16 >> k, lo ^ U32
        y = x[..., LANE ^ s]
        x = torch.where((LANE & s) != 0, (x & hi) | ((y & hi) >> s),
                        (x & lo) | (((y & lo) << s) & U32))
    return x.movedim(-1, dim)


def _k2_register_warp(MW: int, NC: int, b, n: int, max_rank: int, A=None, order=None, Hc=None):
    """K2's register instance: lane l's columns 32 t + l as MW words over
    the physical rows, ``c (B, lane, NC, MW)``; b as MW words every lane
    holds; lane l's key of row 32 g + l. Loads packed rows A (B, m, nw) by
    the transpose, or (order, Hc) columns. Returns (A in position order or
    None, b (B, m), piv (B, m)) as int32."""
    B, m = b.shape
    c = torch.zeros((B, WORD, NC, MW), dtype=torch.int64)
    if A is not None:
        nw = A.shape[2]
        rows = torch.zeros((B, WORD * MW, NC), dtype=torch.int64)
        rows[:, :m, :nw] = _u(A)
        x = rows.view(B, MW, WORD, NC).permute(0, 2, 3, 1)  # (B, lane i: row 32 g + i, t, g)
        c = _transpose32(x, 1)  # lane l: column 32 t + l, word g
    else:
        mwh = Hc.shape[1]
        k = torch.arange(NC * WORD).view(NC, WORD).T  # (lane, t): column 32 t + l
        real = k < n
        cols = _u(Hc)[order[:, k.clamp(max=n - 1)].long()]  # (B, lane, t, mwh)
        c[..., :mwh] = torch.where(real[None, :, :, None], cols, 0)
    rows_b = torch.zeros((B, WORD * MW), dtype=torch.int64)
    rows_b[:, :m] = b.to(torch.int64) & 1
    bv = (rows_b.view(B, MW, WORD) << LANE).sum(-1)  # the ballot of each row group
    r = LANE[:, None] + WORD * torch.arange(MW)[None, :]  # (lane, g): the lane's rows
    key = (r << 16 | r).expand(B, -1, -1).clone()
    piv = torch.full((B, m), -1, dtype=torch.int64)
    rank = torch.zeros(B, dtype=torch.int64)
    bidx = torch.arange(B)
    g_ids = torch.arange(MW)
    for T in range(NC):
        for i in range(WORD):
            j = WORD * T + i
            if j >= n:
                break
            live = rank < max_rank
            col = c[:, i, T, :]  # __shfl_sync from lane i: (B, MW)
            at = (rank << 16)[:, None, None]
            hold = ((col[:, None, :] >> LANE[None, :, None]) & 1) == 1
            best = torch.where(hold & (key >= at), key, NONE).amin(dim=(1, 2))  # the reduce
            has = (best != NONE) & live
            ppos, p = best >> 16, best & 0xFFFF
            pos = key >> 16
            trade = (has & (ppos != rank))[:, None, None] & (
                (pos == ppos[:, None, None]) | (pos == rank[:, None, None]))
            key = torch.where(trade, key ^ ((ppos ^ rank) << 16)[:, None, None], key)
            e = torch.where((g_ids[None, :] == (p >> 5)[:, None]) & has[:, None],
                            1 << (p & 31)[:, None], 0)
            M = col ^ e
            before = ((c[:, :, :T, :] & e[:, None, None, :]) != 0).any(-1)
            assert not bool(before.any()), "a column before the step holds the pivot row's bit"
            for t in range(T, NC):
                hit = ((c[:, :, t, :] & e[:, None, :]) != 0).any(-1)  # (B, lane)
                c[:, :, t, :] = torch.where(hit[..., None], c[:, :, t, :] ^ M[:, None, :],
                                            c[:, :, t, :])
            bp = ((bv & e) != 0).any(-1)
            bv = torch.where(bp[:, None], bv ^ M, bv)
            piv[bidx[has], rank[has]] = j
            rank = rank + has.long()
    pos = key >> 16  # (B, lane, g): row 32 g + lane's final position
    b_out = torch.zeros((B, WORD * MW), dtype=torch.int64)
    b_bits = (bv[:, None, :] >> LANE[None, :, None]) & 1
    b_out.scatter_(1, pos.reshape(B, -1), b_bits.reshape(B, -1))
    A_out = None
    if A is not None:
        nw = A.shape[2]
        y = _transpose32(c, 1)  # lane i: row 32 g + i's word t, (B, lane, t, g)
        out = torch.zeros((B, WORD * MW, NC), dtype=torch.int64)
        out.scatter_(1, pos.reshape(B, -1)[..., None].expand(-1, -1, NC),
                     y.permute(0, 1, 3, 2).reshape(B, -1, NC))
        A_out = _i32(out[:, :m, :nw])
    return A_out, b_out[:, :m].to(torch.int32), piv.to(torch.int32)


def _k2_shared_warp(A, b, n: int, max_rank: int):
    """K2's shared instance: the rows in place, the position of each row
    and the row at each position as tables; per column the least (position,
    row) key among the rows holding the bit at or below the rank, the two
    tables' entries traded, the pivot row XORed into every other row
    holding the bit and b with it. Returns (A, b, piv) in position order."""
    B, m, nw = A.shape
    rows, bb = _u(A).clone(), b.to(torch.int64) & 1
    pos_of = torch.arange(m).expand(B, -1).clone()
    row_at = pos_of.clone()
    piv = torch.full((B, m), -1, dtype=torch.int64)
    rank = torch.zeros(B, dtype=torch.int64)
    bidx, rid = torch.arange(B), torch.arange(m)
    for j in range(n):
        w, bit = divmod(j, WORD)
        hold = ((rows[:, :, w] >> bit) & 1) == 1
        key = pos_of << 16 | rid
        best = torch.where(hold & (key >= (rank << 16)[:, None]), key, NONE).amin(1)
        has = (best != NONE) & (rank < max_rank)
        ppos, p = (best >> 16)[has], (best & 0xFFFF)[has]
        hb, rk = bidx[has], rank[has]
        q = row_at[hb, rk]
        row_at[hb, ppos], pos_of[hb, q] = q, ppos
        row_at[hb, rk], pos_of[hb, p] = p, rk
        pc = (best & 0xFFFF).clamp(max=m - 1)
        elim = hold & (rid[None, :] != pc[:, None]) & has[:, None]
        rows = torch.where(elim[..., None], rows ^ rows[bidx, pc][:, None, :], rows)
        bb = torch.where(elim, bb ^ bb[bidx, pc][:, None], bb)
        piv[hb, rk] = j
        rank = rank + has.long()
    A_out = torch.gather(rows, 1, row_at[..., None].expand(-1, -1, nw))
    return _i32(A_out), torch.gather(bb, 1, row_at).to(torch.int32), piv.to(torch.int32)


def _system(case: str, B: int, seed: int):
    """(H, order (B, n), b (B, m)): a code's Hx; random dense systems (a
    third of the bits set: the first candidate is seldom at the rank, so
    most pivots trade positions) with a dependent row; the [[144]] code
    with its rows doubled (rank-deficient)."""
    rng = np.random.default_rng(seed)
    if case.startswith("random"):
        m, n = map(int, case.split()[1].split("x"))
        H = (rng.random((m, n)) < 0.33).astype(np.uint8)
        H[-1] = H[0] ^ H[1]
    elif case == "[[144]] doubled rows":
        Hx = get_code("[[144, 12, 12]]").Hx
        H = np.concatenate([Hx, Hx[::-1]])
    else:
        H = get_code(case).Hx
    m, n = H.shape
    order = np.stack([rng.permutation(n) for _ in range(B)])
    b = (rng.random((B, m)) < 0.5).astype(np.int32)
    return H, torch.from_numpy(order), torch.from_numpy(b)


CASES = ["steane", "[[72, 12, 6]]", "[[90, 8, 10]]", "random 40x72", "random 70x150",
         "[[144]] doubled rows"]


def _rows(H, order):
    return pack_rows(torch.from_numpy(H)[:, order].permute(1, 0, 2))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("stop", ["rank", "half-rank"])
def test_register_warp_matches_plain(case, stop):
    """Both loaders of the register instance (at the instance the launcher
    picks) against ``eliminate_rows_plain`` and ``eliminate_ordered_plain``,
    at rank(H) and at an early stop."""
    H, order, b = _system(case, 24, seed=len(case))
    m, n = H.shape
    nw = -(-n // WORD)
    MW, NC = REG_INSTANCES[launch_instance(m, nw)]
    rank = int(gf2.rank(H))
    max_rank = rank if stop == "rank" else rank // 2
    A = _rows(H, order)
    Hc = torch.from_numpy(pack_columns(H))
    ref = eliminate_rows_plain(A, b, n, max_rank)
    got = _k2_register_warp(MW, NC, b, n, max_rank, A=A)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    _, ob, op = _k2_register_warp(MW, NC, b, n, max_rank, order=order, Hc=Hc)
    assert torch.equal(ob, ref[1]) and torch.equal(op, ref[2])
    pb, pp = eliminate_ordered_plain(order, b, Hc, max_rank)
    assert torch.equal(pb, ref[1]) and torch.equal(pp, ref[2])
    assert int((ref[2] >= 0).sum(1).max()) == max_rank


@pytest.mark.parametrize("case", CASES)
def test_shared_warp_matches_plain(case):
    H, order, b = _system(case, 24, seed=3 + len(case))
    n = H.shape[1]
    for max_rank in (int(gf2.rank(H)), H.shape[0] // 3):
        A = _rows(H, order)
        ref = eliminate_rows_plain(A, b, n, max_rank)
        for g, r in zip(_k2_shared_warp(A, b, n, max_rank), ref):
            assert torch.equal(g, r)


@pytest.mark.parametrize("case", ["[[72, 12, 6]]", "random 40x72", "[[144]] doubled rows"])
def test_warps_match_jax_lanes_and_pallas(case):
    """Full eliminations (the JAX kernel has no rank stop) on 128 samples:
    both models against the JAX lanes elimination and ``_elim_kernel`` in
    interpret mode, A, b and piv_col."""
    H, order, b = _system(case, 128, seed=11)
    m, n = H.shape
    nw = -(-n // WORD)
    osd = JaxOSDDecoder(H, JaxOSDConfig(order=0))
    Hp = np.stack([H[:, o] for o in order.numpy()])
    Aj = osd._pack_lanes(jnp.asarray(Hp))
    bj = jnp.asarray(b.numpy().T, jnp.uint32)
    A1, b1, _, p1 = osd._eliminate_lanes(Aj, bj)
    A2, b2, p2 = eliminate_pallas(Aj, bj, n=n, batch_tile=128, interpret=True)
    refs = [(np.asarray(A1), np.asarray(b1), np.asarray(p1)),
            (np.asarray(A2), np.asarray(b2), np.asarray(p2))]
    A = _rows(H, order)
    MW, NC = REG_INSTANCES[launch_instance(m, nw)]
    for got in (_k2_register_warp(MW, NC, b, n, m, A=A), _k2_shared_warp(A, b, n, m)):
        ga = got[0].numpy().view(np.uint32).transpose(1, 2, 0)
        gb = got[1].numpy().astype(np.uint32).T
        gp = got[2].numpy().T
        for ra, rb, rp in refs:
            assert np.array_equal(ga, ra) and np.array_equal(gb, rb) and np.array_equal(gp, rp)


def test_register_warp_carries_bits_beyond_n():
    """Packed rows with bits set past column n: the plain version XORs
    whole rows, and so does the register instance (those columns are
    loaded and updated, never pivoted)."""
    H, order, b = _system("steane", 16, seed=5)
    n = H.shape[1]
    A = _rows(H, order)
    A[:, :, 0] |= torch.from_numpy(np.random.default_rng(6).integers(0, 2, A.shape[:2]) << 31).int()
    ref = eliminate_rows_plain(A, b, n, 3)
    for g, r in zip(_k2_register_warp(1, 1, b, n, 3, A=A), ref):
        assert torch.equal(g, r)
    assert bool((ref[0][:, :, 0] < 0).any())


@pytest.mark.parametrize("code_name", ["steane", "[[144, 12, 12]]"])
def test_ordered_loader_is_the_rows_path(code_name):
    """``eliminate_ordered`` on H's packed columns equals the packed-rows
    elimination of the permuted copy of H, at rank(H), as the OSD decoder
    used it before."""
    H, order, b = _system(code_name, 64, seed=9)
    rank = int(gf2.rank(H))
    _, rb, rp = eliminate_rows_plain(_rows(H, order), b, H.shape[1], rank)
    ob, op = eliminate_ordered(order, b, torch.from_numpy(pack_columns(H)), rank)
    assert torch.equal(ob, rb) and torch.equal(op, rp)


@pytest.mark.parametrize("m,n,instance", [
    (3, 7, 0), (36, 72, 1), (45, 90, 1), (54, 108, 1), (72, 144, 2), (144, 288, 3),
    (33, 200, 3), (161, 200, -1), (300, 600, -1), (673, 2656, -1)])
def test_instance_follows_the_shape(m, n, instance):
    """The register instances hold the code-capacity codes up to
    [[288,12,18]]; the larger narrow systems take the shared one, whose
    warp needs no more shared memory than the packed rows the OSD
    decoder's rows path admits; a system beyond that is refused."""
    nw = -(-n // WORD)
    assert launch_instance(m, nw) == instance
    if instance < 0:
        assert osd_cuda.shared_instance_bytes(m, nw) <= osd_cuda.rows_smem_bytes(m, nw)
        assert osd_cuda.rows_smem_bytes(m, nw) <= osd_cuda.ROWS_SMEM_LIMIT
    with pytest.raises(ValueError, match="cannot hold"):
        launch_instance(700, 88)


def test_kernel_wrappers_refuse_cpu_tensors():
    H, order, b = _system("steane", 4, seed=1)
    Hc = torch.from_numpy(pack_columns(H))
    with pytest.raises(ValueError, match="one CUDA device"):
        osd_cuda.eliminate_ordered_cuda(order, b, Hc)
    meta = torch.zeros((4, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        eliminate_ordered(order, meta, Hc)
