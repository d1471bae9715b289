"""K4g's decomposition (a sample on a cluster of C blocks, pivot-first
panels), rendered in torch and held to the plain version and the JAX
package.

``_k4g_cluster`` computes the transform elimination the way
``gf2_transform_elim_global.cu`` does: T by slot, slot r owned by block
r // R (R = ceil(m / C)) for the whole walk, and the slot of logical row i
(pslot) kept by block i // R; per panel of 32 columns each block first
computes the panel words of its slots at or below the rank and whether any
of them carries a syndrome bit (the b-exit leaves there, before the panel
changes anything), and a panel where none holds a bit is skipped (nothing
else is read); else the leader gathers those words and b by logical row,
eliminates the panel on the rows at or below the rank holding a bit and the
32 from the rank (recording each pivot's column, panel word, mask over U, b
and slot), and writes the list rows' masks, b and logical rows back to
their slots and their slots to pslot; each row above
the rank replays the panel's pivots in column order; then U (the pivots'
panel-start rows) is staged and each slot takes the U rows of its mask. At
the end T goes to logical order from shared memory, or in place a chunk of
words at a time as from global memory.

Every panel is also walked the sequential way on all rows (the rows above
the rank in the list, as K4 does): the replayed masks and b of the rows
above the rank, and the leader's of the rest, equal that walk's bit for
bit, and the leader's warp rendered lane by lane (``_k4_warp_panel`` on the
list without the rows above the rank) agrees too. The outputs are held bit
for bit to ``eliminate_transform_plain``, to the JAX lanes elimination
(``_eliminate_lanes_T``) and to the Pallas kernel in interpret mode, as
``test_torch_osd_wide.py`` runs them. Inputs come from numpy seeds: the
Steane DEM, random wide systems, and built edge cases (panels without a
pivot, rank(H) reached inside a panel, m not a multiple of 32, C not
dividing the row groups, a block without slots, a lane that starts at its
exit, the b-exit on and off).
"""

import numpy as np
import pytest
import torch

from qldpc_tpu.decoders.osd import OSDConfig as JaxOSDConfig
from qldpc_tpu.decoders.osd import OSDDecoder as JaxOSDDecoder
from qldpc_tpu_torch.ops import osd_transform_cuda as otc
from test_torch_osd_wide import (  # noqa: F401 (steane_dem is a fixture)
    _U32,
    _as_u32,
    _assert_equal,
    _inputs,
    _jax_refs,
    _k4_warp_panel,
    _system,
    _xor_rows,
    steane_dem,
)

torch.set_num_threads(2)


def _bump(stats: dict, key: str, by: int = 1) -> None:
    stats[key] = stats.get(key, 0) + by


def _panel_words(rows: torch.Tensor, hc: torch.Tensor) -> torch.Tensor:
    """The panel word of each row of T (k, mw): bit j = parity(row & hc[j])."""
    if not len(rows):
        return torch.zeros(0, dtype=torch.int64)
    z = _xor_rows(rows[:, None, :] & hc[None], 2)
    bits = otc._parity(z.to(torch.int32)).to(torch.int64)
    return (bits << torch.arange(hc.shape[0])).sum(1)


def _walk(W: dict, bb: dict, phys: dict, rank0: int, ncols: int, stats: dict | None = None):
    """The panel's columns eliminated row by row on the rows given (logical
    row -> panel word, b, slot), the sequential way: per column the first
    row at or after the rank holding the bit, swapped to the rank row, then
    every other row holding it takes the pivot row's word, mask over U with
    the pivot's bit, and b. Returns the masks and the pivots' records
    (column, word, mask, b, slot); W, bb and phys are updated in place."""
    M = {i: 0 for i in W}
    rows = sorted(W)
    rank, pivots = rank0, []
    for j in range(ncols):
        cand = [i for i in rows if i >= rank and W[i] >> j & 1]
        if not cand:
            continue
        p, r = cand[0], rank
        if stats is not None:
            _bump(stats, "swap" if p != r else "pivot on the rank row")
        for v in (W, M, bb, phys):
            v[p], v[r] = v[r], v[p]
        k = len(pivots)
        pivots.append((j, W[r], M[r], bb[r], phys[r]))
        for i in rows:
            if i != r and W[i] >> j & 1:
                W[i] ^= pivots[k][1]
                M[i] ^= pivots[k][2] ^ (1 << k)
                bb[i] ^= pivots[k][3]
        rank += 1
    return M, pivots


def _k4g_cluster(order, b, Hc, h_rank: int, b_exit: bool, C: int, t_smem: bool,
                 stats: dict, chunk: int = 3):
    """K4g as its kernel computes it, in plain torch, one sample at a time,
    the C blocks of its cluster as slot ranges. Same contract as
    ``eliminate_transform_plain``; ``stats`` counts the edge cases met."""
    B, n = order.shape
    m, mw = b.shape[1], Hc.shape[1]
    hc_all = Hc.to(torch.int64) & _U32
    R = -(-m // C)
    blocks = [torch.arange(min(m, c * R), min(m, (c + 1) * R)) for c in range(C)]
    if any(not len(own) for own in blocks):
        _bump(stats, "block without slots")
    if C > 1 and (-(-m // 32)) % C:
        _bump(stats, "C not dividing the row groups")
    T_out = torch.zeros((B, m, mw), dtype=torch.int64)
    b_out = torch.zeros((B, m), dtype=torch.int64)
    rank_out = torch.zeros(B, dtype=torch.int64)
    piv_out = torch.full((B, m), -1, dtype=torch.int64)
    for s in range(B):
        T = otc._identity(1, m, mw, "cpu")[0].to(torch.int64) & _U32  # by slot
        lrow = list(range(m))  # slot -> logical row, each block its own slots'
        bsl = b[s].to(torch.int64).tolist()  # b by slot
        Msl = [0] * m
        pslot = list(range(m))  # logical row -> slot, block i // R keeps row i's
        piv = [-1] * m
        rank = 0
        if h_rank <= 0:
            _bump(stats, "lane at its exit before the first panel")
        for col0 in range(0, n, 32):
            if rank >= h_rank:
                break
            hc = hc_all[order[s, col0:col0 + 32].long()]
            ncols = hc.shape[0]

            # 1. each block: the words of its slots at or below the rank, and
            #    whether any of them carries a syndrome bit
            Wsl, flags, unresolved = {}, [], []
            for own in blocks:
                below = [r for r in own.tolist() if lrow[r] >= rank]
                words = _panel_words(T[below], hc).tolist()
                for r, w in zip(below, words):
                    Wsl[r], Msl[r] = w, 0
                flags.append(any(words))
                unresolved.append(any(bsl[r] for r in below))
            if b_exit and not any(unresolved):  # the b-exit: nothing has changed
                _bump(stats, "b-exit" if col0 else "lane at its exit before the first panel")
                break
            _bump(stats, "panels")
            # the reference: every logical row's word, walked the sequential way
            W_all = _panel_words(T[pslot], hc).tolist()
            ref_W = dict(enumerate(W_all))
            ref_b = {i: bsl[p] for i, p in enumerate(pslot)}  # b by logical row
            ref_phys = dict(enumerate(pslot))
            ref_M, ref_piv = _walk(ref_W, ref_b, ref_phys, rank, ncols)
            if not any(flags):
                _bump(stats, "panel without a pivot")
                assert not ref_piv  # the sequential walk finds none either
                continue
            # 2. the leader: the words, slots and b by logical row (through
            #    pslot), the walk on the rows at or below the rank holding a
            #    bit and the 32 from the rank
            Wl = {i: Wsl[pslot[i]] for i in range(rank, m)}
            listed = {i: w for i, w in Wl.items() if w or i < rank + 32}
            _bump(stats, "rows at or below the rank off the list", len(Wl) - len(listed))
            lb, lphys = {i: bsl[pslot[i]] for i in listed}, {i: pslot[i] for i in listed}
            warp_in = ([Wl.get(i, 0) for i in range(m)], [bsl[p] for p in pslot], list(pslot),
                       list(piv))
            warp_out = _k4_warp_panel(*warp_in, rank, ncols, col0, stats)
            M, pivots = _walk(listed, lb, lphys, rank, ncols, stats)
            for k, (j, *_rest) in enumerate(pivots):
                piv[rank + k] = col0 + j
            new_rank = rank + len(pivots)
            if new_rank >= h_rank and pivots and pivots[-1][0] + 1 < ncols:
                _bump(stats, "rank(H) reached inside a panel")
            for i in listed:
                slot = lphys[i]
                pslot[i] = slot
                Msl[slot], bsl[slot], lrow[slot] = M[i], lb[i], i
            # the kernel's warp (list without the rows above the rank) agrees
            masks_w, src_w, rank_w = warp_out
            assert warp_in[2] == pslot and warp_in[3] == piv
            assert all(warp_in[1][i] == lb[i] for i in listed)
            assert rank_w == new_rank and src_w == [p[4] for p in pivots]
            assert all(masks_w[i] == M[i] for i in listed)
            # 3. each block: its rows above the rank replay the pivots
            for own in blocks:
                for r in own.tolist():
                    if lrow[r] >= rank:
                        continue
                    wv = int(_panel_words(T[r:r + 1], hc)[0])
                    mk, bit = 0, bsl[r]
                    if wv:
                        _bump(stats, "rows above the rank holding a bit")
                    for k, (j, pw, pm, pb, _) in enumerate(pivots):
                        if wv >> j & 1:
                            wv ^= pw
                            mk ^= pm ^ (1 << k)
                            bit ^= pb
                    Msl[r], bsl[r] = mk, bit
            # the sequential walk on all rows gives every row the same mask,
            # b and slot
            for i in range(m):
                assert pslot[i] == ref_phys[i]
                assert Msl[pslot[i]] == ref_M[i] and bsl[pslot[i]] == ref_b[i], (col0, i)
            # 4. U staged, then every slot takes the U rows of its mask
            U = T[[p[4] for p in pivots]]
            ks = torch.arange(len(pivots))
            mask = torch.tensor(Msl)
            take = ((mask[:, None] >> ks) & 1 == 1)[..., None]
            T = T ^ _xor_rows(torch.where(take, U[None], 0), 1)
            rank = new_rank
        # T into logical order: from shared memory directly, or in place a
        # chunk of words at a time (staged, then written) as from global memory
        if t_smem:
            out = torch.zeros_like(T)
            out[lrow] = T
        else:
            out = T.clone()
            for w0 in range(0, mw, chunk):
                stage = out[:, w0:w0 + chunk].clone()
                out[lrow, w0:w0 + chunk] = stage
        T_out[s] = out
        b_out[s, lrow] = torch.tensor(bsl)
        rank_out[s], piv_out[s] = rank, torch.tensor(piv)
    as_i32 = lambda x: torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)  # noqa: E731
    return as_i32(T_out), b_out.to(torch.int32), rank_out.to(torch.int32), piv_out.to(torch.int32)


def _hold(H, order, resid, b_exit, C, t_smem, stats, jax_too=True):
    """The rendering against ``eliminate_transform_plain`` and the JAX
    references, bit for bit."""
    h_rank = int(JaxOSDDecoder(H)._H_rank) if H.any() else 0
    args = (torch.from_numpy(np.ascontiguousarray(order)),
            torch.from_numpy(resid.astype(np.int32)), torch.from_numpy(otc.pack_columns(H)),
            h_rank, b_exit)
    got = _k4g_cluster(*args, C, t_smem, stats)
    for g, r in zip(got, otc.eliminate_transform_plain(*args)):
        assert torch.equal(g, r)
    if jax_too:
        got = (_as_u32(got[0]), _as_u32(got[1]), got[2].numpy(), got[3].numpy())
        # the Pallas kernel checks its exits after each chunk, not before the
        # first: lanes without a syndrome bit are held to the plain version
        live = resid.any(axis=1)
        dec = JaxOSDDecoder(H, JaxOSDConfig(order=0, backend="lanes"))
        for ref in _jax_refs(H, dec, order[live], resid[live], b_exit):
            _assert_equal(tuple(x[live] for x in got), ref)
    return got


@pytest.mark.parametrize("b_exit", [False, True])
@pytest.mark.parametrize("kind,C", [("steane-dem", 1), ("steane-dem", 8),
                                    ("random-wide", 3), ("random-wide", 16)])
def test_k4g_cluster_matches_plain_and_jax(rng, steane_dem, kind, C, b_exit):
    """The decomposition on OSD's inputs (the BP failures), with T in shared
    and in global memory, bit for bit against the plain version, the JAX
    lanes elimination and the Pallas kernel in interpret mode."""
    H, syn, llrs, hard = _inputs(rng, kind, steane_dem, 96)
    _, order, resid = _system(H, syn, llrs, hard)
    live = resid.any(axis=1)
    order, resid = order[live][:12], resid[live][:12]
    stats = {}
    _hold(H, order, resid, b_exit, C, t_smem=C % 2 == 0, stats=stats)
    assert stats["panels"] > 0 and stats.get("swap", 0) > 0
    if kind == "random-wide":  # 40 rows: two groups over three or eight blocks
        assert stats["C not dividing the row groups"] and stats["rows above the rank holding a bit"]
    if C >= 8:  # R = 3: the last blocks hold no slot
        assert stats["block without slots"]


def _repeating(rng, m: int = 70, dependent: int = 4):
    """A rank-deficient wide system whose order repeats a panel's columns:
    the first 32 columns, then the same columns again (their duplicates in
    H) for three panels, then the rest. Columns of weight 2-4 on the first m
    - dependent rows; the last rows are sums of pairs of earlier ones."""
    base = np.zeros((m, 32 + 400), np.uint8)  # wide enough for JAX's transform
    for j in range(base.shape[1]):
        base[rng.choice(m - dependent, size=rng.integers(2, 5), replace=False), j] = 1
    base[m - dependent:] = base[:dependent] ^ base[dependent:2 * dependent]
    H = np.concatenate([base[:, :32]] * 4 + [base[:, 32:]], axis=1)
    return H


@pytest.mark.parametrize("b_exit", [False, True])
@pytest.mark.parametrize("C,t_smem", [(1, False), (2, True), (4, False), (5, True)])
def test_k4g_cluster_edge_cases(rng, C, t_smem, b_exit):
    """Panels with no pivot (a panel's columns repeated), lanes outside H's
    image that walk to rank(H), rank(H) reached inside a panel, m = 70 (not
    a multiple of 32) over C blocks that do not divide its three row
    groups, a lane with no syndrome bit (with the b-exit it stops before its
    first panel) and one whose syndrome the first panel resolves (the b-exit
    after it), all bit for bit to the plain version and JAX."""
    H = _repeating(rng)
    m, n = H.shape
    B = 6
    order = np.tile(np.arange(n), (B, 1))
    for s in range(2, B):  # shuffle the columns past the repeats
        order[s, 128:] = 128 + rng.permutation(n - 128)
    e = (rng.random((B, n)) < 0.03).astype(np.int64)
    resid = (e @ H.T) % 2
    resid[1::2, -1] ^= 1  # a dependent row: outside H's image, walks to rank(H)
    resid[0] = 0
    resid[2] = H[:, 5]  # in the span of the first panel: with the b-exit it stops after it
    stats = {}
    got = _hold(H, order, resid, b_exit, C, t_smem, stats)
    h_rank = int(JaxOSDDecoder(H)._H_rank)
    assert (got[2][1::2] == h_rank).all()
    assert stats["panel without a pivot"] >= 3 * 3  # the repeats, on the lanes outside
    assert stats["rank(H) reached inside a panel"] > 0
    if C > 1:
        assert stats["C not dividing the row groups"]
    if b_exit:
        assert stats["lane at its exit before the first panel"] and stats["b-exit"]


def test_k4g_cluster_without_rank():
    """H = 0 (rank 0): every lane is at rank(H) before its first panel; T is
    the identity, b unchanged, no pivot, as the plain version leaves them."""
    H = np.zeros((40, 96), np.uint8)
    rng = np.random.default_rng(3)
    order = np.argsort(rng.random((3, 96)), axis=1)
    resid = rng.integers(0, 2, (3, 40))
    stats = {}
    got = _hold(H, order, resid, False, 2, True, stats, jax_too=False)
    assert stats["lane at its exit before the first panel"] == 3 and "panels" not in stats
    assert torch.equal(got[1], torch.from_numpy(resid.astype(np.int32)))
    assert bool((got[3] == -1).all())
