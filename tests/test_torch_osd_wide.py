"""The port's wide-system OSD-0 (transform elimination) against the JAX
package.

Inputs come from numpy seeds: the Steane memory-experiment DEM of the JAX
tests (18 detectors x 267 mechanisms: 9 words against 1, so the transform
path) with BP(8) posteriors as LLRs, and a random wide system. The JAX side
runs its XLA transform elimination (``_eliminate_lanes_T``) and its Pallas
kernel in interpret mode; the port runs its plain torch versions. Every
comparison is bit for bit:

  * without the b-exit, T, b, rank and piv_col equal the batched JAX runs;
  * with the b-exit, a sample stops at its own 32-column boundary, where
    the JAX paths stop their whole batch or lane tile: the port equals the
    JAX elimination vmapped over single samples and the Pallas kernel with
    one-lane tiles and 32-column chunks, and the solutions equal the batched
    runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpc_tpu.codes import get_code
from qldpc_tpu.decoders import BPConfig as JaxBPConfig
from qldpc_tpu.decoders import BPDecoder as JaxBPDecoder
from qldpc_tpu.decoders.osd import OSDConfig as JaxOSDConfig
from qldpc_tpu.decoders.osd import OSDDecoder as JaxOSDDecoder
from qldpc_tpu.noise.circuit import memory_experiment_dem
from qldpc_tpu.ops.osd_transform_pallas import eliminate_transform_pallas
from qldpc_tpu_torch.decoders import OSDDecoder
from qldpc_tpu_torch.ops import osd_transform_cuda as otc

torch.set_num_threads(2)


def _as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def steane_dem():
    return memory_experiment_dem(get_code("steane"), p=0.01, rounds=3)


def _random_wide(rng, m=40, n=700):
    """Columns of weight 1-3: rank-deficient wide systems with repeats."""
    H = np.zeros((m, n), np.uint8)
    for j in range(n):
        H[rng.choice(m, size=rng.integers(1, 4), replace=False), j] = 1
    H[-1] = H[0] ^ H[1]  # a dependent row
    return H


def _inputs(rng, kind, dem, B):
    """(H, syndromes, llrs, hard) with BP(8) outputs for the DEM."""
    if kind == "steane-dem":
        H, prob = dem.H, dem.priors
        mech = (rng.random((B, H.shape[1])) < prob).astype(np.int8)
        syn = ((mech.astype(np.int64) @ H.T) % 2).astype(np.int8)
        r = JaxBPDecoder(H, JaxBPConfig(max_iter=8))(jnp.asarray(syn),
                                                      jnp.asarray(dem.llrs, jnp.float32))
        return H, syn, np.array(r.llrs), np.array(r.hard)
    H = _random_wide(rng)
    e = (rng.random((B, H.shape[1])) < 0.02).astype(np.int8)
    syn = ((e.astype(np.int64) @ H.T) % 2).astype(np.int8)
    llrs = rng.normal(2.0, 2.0, (B, H.shape[1])).astype(np.float32)
    llrs[:, ::7] = 1.5  # exact ties: the stable sort decides them
    return H, syn, llrs, (llrs < 0).astype(np.int8)


def _system(H, syn, llrs, hard):
    """The JAX decoder, the permutation and residual both packages eliminate."""
    dec = JaxOSDDecoder(H, JaxOSDConfig(order=0, backend="lanes"))
    assert dec._use_transform
    order = np.array(jnp.argsort(jnp.abs(jnp.asarray(llrs)), axis=1, stable=True))
    resid = (syn.astype(np.int64) + (hard.astype(np.int64) @ H.T)) % 2
    return dec, order, resid


def _port(H, order, resid, b_exit):
    T, b, rank, piv = otc.eliminate_transform(
        torch.from_numpy(order), torch.from_numpy(resid.astype(np.int32)),
        torch.from_numpy(otc.pack_columns(H)), int(JaxOSDDecoder(H)._H_rank), b_exit,
    )
    return _as_u32(T), _as_u32(b), rank.numpy(), piv.numpy()


def _assert_equal(got, ref):
    for name, g, r in zip(("T", "b", "rank", "piv_col"), got, ref):
        assert np.array_equal(g, r), name


@pytest.mark.parametrize("kind", ["steane-dem", "random-wide"])
def test_pack_columns_and_identity_match_jax(rng, steane_dem, kind):
    H = _inputs(rng, kind, steane_dem, 4)[0]
    dec = JaxOSDDecoder(H, JaxOSDConfig(order=0))
    assert np.array_equal(otc.pack_columns(H).view(np.uint32), np.asarray(dec._Hc))
    T0 = otc._identity(2, dec.m, dec.m_words, "cpu")
    assert np.array_equal(_as_u32(T0[1]), np.asarray(dec._T0))


@pytest.mark.parametrize("kind", ["steane-dem", "random-wide"])
def test_transform_elimination_matches_lanes_and_pallas(rng, steane_dem, kind):
    H, syn, llrs, hard = _inputs(rng, kind, steane_dem, 96)
    dec, order, resid = _system(H, syn, llrs, hard)
    b = jnp.asarray(resid.T, jnp.uint32)
    T1, b1, r1, p1 = dec._eliminate_lanes_T(jnp.asarray(order), b)
    ref = (np.asarray(T1).transpose(2, 0, 1), np.asarray(b1).T, np.asarray(r1), np.asarray(p1).T)
    got = _port(H, order, resid, b_exit=False)
    _assert_equal(got, ref)
    assert (got[2] == dec._H_rank).all()
    pal = JaxOSDDecoder(H, JaxOSDConfig(order=0, backend="pallas"))
    T2, b2, r2, p2 = pal._eliminate_lanes_T_pallas(jnp.asarray(order), b)
    _assert_equal(got, (np.asarray(T2).transpose(2, 0, 1), np.asarray(b2).T,
                        np.asarray(r2), np.asarray(p2).T))


@pytest.mark.parametrize("kind", ["steane-dem", "random-wide"])
def test_b_exit_matches_jax_per_sample(rng, steane_dem, kind):
    H, syn, llrs, hard = _inputs(rng, kind, steane_dem, 96)
    dec, order, resid = _system(H, syn, llrs, hard)
    # what OSD sees: samples with a residual syndrome (the BP failures)
    live = resid.any(axis=1)
    order, resid = order[live][:24], resid[live][:24]
    assert len(resid) >= 8
    got = _port(H, order, resid, b_exit=True)
    assert (got[2] < dec._H_rank).any()  # some samples left early

    def one(o, b):
        T, bb, r, p = dec._eliminate_lanes_T(o[None], b[:, None], b_exit=True)
        return T[..., 0], bb[:, 0], r[0], p[:, 0]

    ref = jax.jit(jax.vmap(one))(jnp.asarray(order), jnp.asarray(resid, jnp.uint32))
    _assert_equal(got, tuple(np.asarray(x) for x in ref))

    # the Pallas kernel, one lane per tile and 32-column chunks (it checks
    # its exits after each chunk, not before the first, which only lanes
    # with b = 0 at the start could tell apart)
    n_pad = -(-dec.n // 32) * 32
    hcp = jnp.pad(dec._Hc.T[:, jnp.asarray(order).T], ((0, 0), (0, n_pad - dec.n), (0, 0)))
    T3, b3, r3, p3 = eliminate_transform_pallas(
        hcp, jnp.asarray(resid.T, jnp.uint32), dec._T0, n=dec.n, h_rank=dec._H_rank,
        b_exit=True, col_chunk=32, batch_tile=1, interpret=True,
    )
    _assert_equal(got, (np.asarray(T3).transpose(2, 0, 1), np.asarray(b3).T,
                        np.asarray(r3)[0], np.asarray(p3).T))


def _rows_cleared(H, order, resid, h_rank, b_exit):
    """The rows the pivots clear, by a dense column-by-column elimination of
    [H[:, order] | b] with the exits at 32-column boundaries."""
    total = 0
    for o, b in zip(order, resid):
        A = np.concatenate([H[:, o], b[:, None]], axis=1).astype(np.uint8)
        rank = 0
        for j in range(H.shape[1]):
            if j % 32 == 0 and (rank >= h_rank or (b_exit and not A[rank:, -1].any())):
                break
            cand = np.flatnonzero(A[rank:, j]) + rank
            if not cand.size:
                continue
            A[[rank, cand[0]]] = A[[cand[0], rank]]
            clear = np.flatnonzero(A[:, j])
            clear = clear[clear != rank]
            A[clear] ^= A[rank]
            total += clear.size
            rank += 1
    return total


@pytest.mark.parametrize("b_exit", [False, True])
@pytest.mark.parametrize("kind", ["steane-dem", "random-wide"])
def test_plain_transform_counts_the_rows_it_clears(rng, steane_dem, kind, b_exit):
    """``cleared`` counts the row operations a dense elimination makes, and
    leaves the outputs as they are without it."""
    H, syn, llrs, hard = _inputs(rng, kind, steane_dem, 24)
    dec, order, resid = _system(H, syn, llrs, hard)
    args = (torch.from_numpy(order), torch.from_numpy(resid.astype(np.int32)),
            torch.from_numpy(otc.pack_columns(H)), int(dec._H_rank), b_exit)
    cleared = torch.zeros((), dtype=torch.int64)
    got = otc.eliminate_transform_plain(*args, cleared=cleared)
    _assert_equal(got, otc.eliminate_transform_plain(*args))
    expect = _rows_cleared(H, order, resid, int(dec._H_rank), b_exit)
    assert expect > 0 and int(cleared) == expect


@pytest.mark.parametrize("kind", ["steane-dem", "random-wide"])
def test_wide_osd_solutions_match_jax(rng, steane_dem, kind):
    H, syn, llrs, hard = _inputs(rng, kind, steane_dem, 96)
    got = OSDDecoder(H)(torch.from_numpy(syn), torch.from_numpy(llrs),
                        torch.from_numpy(hard))
    assert got.dtype == torch.int8
    for backend in ("lanes", "pallas"):
        ref = JaxOSDDecoder(H, JaxOSDConfig(order=0, backend=backend))(syn, llrs, hard)
        assert np.array_equal(got.numpy(), np.asarray(ref)), backend
    # solutions reproduce every syndrome in the image of H
    s_hat = (got.numpy().astype(np.int64) @ H.T) % 2
    assert (s_hat == syn).all(axis=1).mean() > 0.9


def test_wide_decoder_tables(steane_dem):
    dec = OSDDecoder(steane_dem.H)
    assert dec.wide and dec.m_words == 1 and dec.h_rank == JaxOSDDecoder(steane_dem.H)._H_rank
    assert not hasattr(dec, "Hf")  # no dense H for wide systems
    hard = torch.zeros((3, dec.n), dtype=torch.int32)
    hard[1, 5] = hard[2, 100] = 1
    syn = torch.zeros((3, dec.m), dtype=torch.int8)
    expect = (hard.numpy() @ steane_dem.H.T) % 2
    assert np.array_equal(dec._residual(syn, hard).numpy(), expect)


def test_k4_refuses_what_it_cannot_hold():
    assert otc.smem_bytes(432) < otc.SMEM_LIMIT  # [[72,12,6]] DEM: 30 KB
    assert otc.smem_bytes(1728) > otc.SMEM_LIMIT  # [[144,12,12]] DEM: 385 KB
    cpu = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs its operands on one CUDA device"):
        otc.eliminate_transform_cuda(cpu, cpu, cpu, 1)
    meta = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        otc.eliminate_transform(meta, meta, meta, 1)


# ---- K4's panel decomposition, rendered in torch --------------------------

_U32 = 0xFFFFFFFF


def _xor_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    out = x.select(dim, 0).clone() if x.shape[dim] else torch.zeros_like(x.select(dim, 0))
    for k in range(1, x.shape[dim]):
        out ^= x.select(dim, k)
    return out


_KEEP = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)


def _transpose32(x: list) -> list:
    """gf2_transform_elim.cu's transpose32: lane l holds row l of a 32 x 32
    bit matrix and gets column l, by five butterfly stages."""
    for s, keep in zip((16, 8, 4, 2, 1), _KEEP):
        y = [x[lane ^ s] for lane in range(32)]
        x = [((x[lane] & ~keep) | ((y[lane] & ~keep) >> s)) & _U32 if lane & s
             else ((x[lane] & keep) | ((y[lane] & keep) << s)) & _U32 for lane in range(32)]
    return x


def _k4_warp_panel(W, bb, phys, piv, rank0: int, ncols: int, col0: int, stats: dict):
    """gf2_transform_elim.cu's eliminate_panel step by step, lanes as lists:
    the list (rows holding a panel bit and the 32 from the rank, in logical
    order) transposed to three column vectors a lane (word g of lane c's at
    [g][c]): cW, the panel's columns; cM, the masks over U by pivot; cX,
    the row's slot in lanes 0-15 and its b in lane 16. Per column: the first
    position at or after the rank row's holding the bit, the swap of two
    bits in every vector, the XOR of column j (without the pivot's bit) into
    the W columns the pivot row holds, the M columns of its mask and pivot
    k, and the b column if its b is set; the pivot's slot is its X bits.
    Returns (the masks over U, the pivots' slots, the rank); the slots, b
    and piv_col are updated in place."""
    m = len(W)
    lab = [i for i in range(m) if W[i] or rank0 <= i < rank0 + 32]
    L, prank = len(lab), sum(i < rank0 for i in lab)
    LG = -(-L // 32)
    if LG > 1:
        stats["list over several words"] = stats.get("list over several words", 0) + 1
    cW, cX, cM = [], [], [[0] * 32 for _ in range(LG)]
    for g in range(LG):
        qs = range(32 * g, 32 * g + 32)
        cW.append(_transpose32([W[lab[q]] if q < L else 0 for q in qs]))
        cX.append(_transpose32([phys[lab[q]] | bb[lab[q]] << 16 if q < L else 0 for q in qs]))
    k, src, mypiv = 0, [], [-1] * 32
    for j in range(ncols):
        pr, q = prank + k, None
        for g in range(LG):
            lo = pr - 32 * g
            x = 0 if lo >= 32 else cW[g][j] & (_U32 << lo) & _U32 if lo > 0 else cW[g][j]
            if x:
                q = 32 * g + (x & -x).bit_length() - 1
                break
        if q is None:
            continue
        gq, gr, eq, er = q >> 5, pr >> 5, 1 << (q & 31), 1 << (pr & 31)
        hw, hm, hx = ([bool(arr[gq][c] & eq) for c in range(32)] for arr in (cW, cM, cX))
        if q != pr:
            if gq != gr:
                stats["swap across list words"] = stats.get("swap across list words", 0) + 1
            for arr in (cW, cM, cX):
                for c in range(32):
                    if bool(arr[gq][c] & eq) != bool(arr[gr][c] & er):
                        arr[gq][c] ^= eq
                        arr[gr][c] ^= er
        src.append(sum(hx[c] << c for c in range(16)))  # the ballot of the X bits
        mypiv[k] = col0 + j
        for g in range(LG):
            sv = cW[g][j] & ~(er if g == gr else 0)
            for c in range(32):
                if hw[c] and c != j:
                    cW[g][c] ^= sv
                if hm[c] or c == k:
                    cM[g][c] ^= sv
                if c == 16 and hx[c]:
                    cX[g][c] ^= sv
        k += 1
    masks = [0] * m
    for g in range(LG):
        rows_x, rows_m = _transpose32(cX[g]), _transpose32(cM[g])
        for lane in range(32):
            if 32 * g + lane < L:
                i = lab[32 * g + lane]
                phys[i], bb[i] = rows_x[lane] & 0xFFFF, (rows_x[lane] >> 16) & 1
                masks[i] = rows_m[lane]
    for lane in range(k):
        piv[rank0 + lane] = mypiv[lane]
    return masks, src, rank0 + k


def _k4_panels(order, b, Hc, h_rank: int, b_exit: bool, stats: dict):
    """K4 as its kernel computes it, in plain torch, one sample at a time.
    T stays in its slots (logical row i lives in slot phys[i]); per panel of
    32 columns: the staged columns give each logical row one word W (bit j
    the row's bit in column col0 + j); the columns are eliminated on W
    alone, the swap moving W, b, the masks and the slot, every XOR
    recording the pivot in the row's mask M over U (U_k, the panel-start
    row of pivot k's slot; a pivot at its time is U_k ^ its M); then every
    slot takes its M's U rows. The same panel is also applied the way of
    the pivot triangle (P_k = U_k ^ the earlier P in pivot k's mask over P
    at its time, each row XORing the P of its mask over P), which must give
    the same T. Only the kernel's list of rows (those holding a panel bit
    and the 32 from the rank) may be candidates, rank rows or eliminated.
    ``stats`` counts the edge cases met. Same contract as
    ``eliminate_transform_plain``."""
    B, n = order.shape
    m, mw = b.shape[1], Hc.shape[1]
    hc_all = Hc.to(torch.int64) & _U32
    rows = torch.arange(m)

    def bump(key):
        stats[key] = stats.get(key, 0) + 1

    T_out = torch.zeros((B, m, mw), dtype=torch.int64)
    b_out = torch.zeros((B, m), dtype=torch.int64)
    rank_out = torch.zeros(B, dtype=torch.int64)
    piv_out = torch.full((B, m), -1, dtype=torch.int64)
    for s in range(B):
        T = otc._identity(1, m, mw, "cpu")[0].to(torch.int64) & _U32  # by slot
        phys, bb = rows.clone(), b[s].to(torch.int64).clone()
        piv = torch.full((m,), -1, dtype=torch.int64)
        rank = 0
        for col0 in range(0, n, 32):
            if rank >= h_rank:
                break
            if b_exit and not bool((bb[rank:] != 0).any()):
                bump("b-exit")
                break
            hc = hc_all[order[s, col0:col0 + 32].long()]  # the staged columns
            ncols = hc.shape[0]
            if ncols < 32:
                bump("partial panel")
            z = _xor_rows(T[phys][:, None, :] & hc[None], 2)  # (m, ncols)
            bits = otc._parity(z.to(torch.int32)).to(torch.int64)
            W = (bits << torch.arange(ncols)).sum(1)
            M = torch.zeros(m, dtype=torch.int64)  # over U
            MP = torch.zeros(m, dtype=torch.int64)  # over P, the triangle's form
            src, pmask, rank0 = [], [], rank
            warp = (W.tolist(), bb.tolist(), phys.tolist(), piv.tolist())
            warp = (*warp, *_k4_warp_panel(*warp, rank0, ncols, col0, stats))
            # the kernel's list: the rows holding a panel bit and the 32 from
            # the rank; no other row is a candidate, a rank row or eliminated
            listed = (W != 0) | ((rows >= rank0) & (rows < rank0 + 32))
            stats["rows outside the list"] = stats.get("rows outside the list", 0) + int(
                (~listed).sum())
            for j in range(ncols):
                cand = (((W >> j) & 1) == 1) & (rows >= rank)
                if not bool(cand.any()):
                    continue
                p, r, k = int(cand.nonzero()[0]), rank, len(src)
                assert not bool((cand & ~listed).any()) and bool(listed[r])
                bump("pivot on the rank row" if p == r else "swap")
                for v in (W, M, MP, bb, phys):
                    v[[p, r]] = v[[r, p]]
                piv[r] = col0 + j
                src.append(int(phys[r]))
                pmask.append(int(MP[r]))
                elim = (((W >> j) & 1) == 1) & (rows != r)
                assert not bool((elim & ~listed).any())
                if bool((elim & (rows >= rank0) & (rows < r)).any()):
                    bump("pivot row eliminated later in its panel")
                W[elim] ^= W[r]
                M[elim] ^= M[r] ^ (1 << k)
                MP[elim] ^= 1 << k
                bb[elim] ^= bb[r]
                rank += 1
                if rank == min(h_rank, m) and j + 1 < ncols:
                    bump("rank(H) reached inside a panel")
            # the kernel's warp, lane by lane, agrees with the row-wise steps
            assert warp[1:4] == (bb.tolist(), phys.tolist(), piv.tolist())
            assert warp[4:] == (M.tolist(), src, rank)
            if not src:
                bump("panel without a pivot")
                continue
            U = T[src]  # the pivots' panel-start rows
            P = []
            for k in range(len(src)):
                P.append(U[k] ^ _xor_rows(torch.stack([P[q] for q in range(k)
                                                        if pmask[k] >> q & 1] or [U[k] * 0]), 0))
            ks = torch.arange(len(src))
            new = T[phys] ^ _xor_rows(torch.where(((M[:, None] >> ks) & 1 == 1)[..., None],
                                                  U[None], 0), 1)
            via_P = T[phys] ^ _xor_rows(torch.where(((MP[:, None] >> ks) & 1 == 1)[..., None],
                                                    torch.stack(P)[None], 0), 1)
            assert torch.equal(new, via_P), "the masks over U and the pivot triangle differ"
            T[phys] = new
        T_out[s], b_out[s], rank_out[s], piv_out[s] = T[phys], bb, rank, piv
    as_i32 = lambda x: torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)
    return as_i32(T_out), b_out.to(torch.int32), rank_out.to(torch.int32), piv_out.to(torch.int32)


def _jax_refs(H, dec, order, resid, b_exit):
    """The JAX lanes elimination and the Pallas kernel in interpret mode:
    batched without the b-exit; with it, one sample at a time (vmapped) and
    one-lane tiles of 32-column chunks."""
    b = jnp.asarray(resid.T, jnp.uint32)
    if not b_exit:
        T1, b1, r1, p1 = dec._eliminate_lanes_T(jnp.asarray(order), b)
        pal = JaxOSDDecoder(H, JaxOSDConfig(order=0, backend="pallas"))
        T2, b2, r2, p2 = pal._eliminate_lanes_T_pallas(jnp.asarray(order), b)
        return [(np.asarray(T).transpose(2, 0, 1), np.asarray(bb).T, np.asarray(r), np.asarray(p).T)
                for T, bb, r, p in ((T1, b1, r1, p1), (T2, b2, r2, p2))]

    def one(o, bs):
        T, bb, r, p = dec._eliminate_lanes_T(o[None], bs[:, None], b_exit=True)
        return T[..., 0], bb[:, 0], r[0], p[:, 0]

    lanes = jax.jit(jax.vmap(one))(jnp.asarray(order), jnp.asarray(resid, jnp.uint32))
    n_pad = -(-dec.n // 32) * 32
    hcp = jnp.pad(dec._Hc.T[:, jnp.asarray(order).T], ((0, 0), (0, n_pad - dec.n), (0, 0)))
    T3, b3, r3, p3 = eliminate_transform_pallas(
        hcp, b, dec._T0, n=dec.n, h_rank=dec._H_rank, b_exit=True, col_chunk=32, batch_tile=1,
        interpret=True,
    )
    return [tuple(np.asarray(x) for x in lanes),
            (np.asarray(T3).transpose(2, 0, 1), np.asarray(b3).T, np.asarray(r3)[0],
             np.asarray(p3).T)]


def _hold_panels(H, order, resid, b_exit, stats):
    """The rendering against ``eliminate_transform_plain`` and both JAX
    references, bit for bit; returns its rank."""
    h_rank = int(JaxOSDDecoder(H)._H_rank)
    args = (torch.from_numpy(order), torch.from_numpy(resid.astype(np.int32)),
            torch.from_numpy(otc.pack_columns(H)), h_rank, b_exit)
    got = _k4_panels(*args, stats)
    for g, r in zip(got, otc.eliminate_transform_plain(*args)):
        assert torch.equal(g, r)
    got = (_as_u32(got[0]), _as_u32(got[1]), got[2].numpy(), got[3].numpy())
    dec = JaxOSDDecoder(H, JaxOSDConfig(order=0, backend="lanes"))
    assert dec._use_transform
    for ref in _jax_refs(H, dec, order, resid, b_exit):
        _assert_equal(got, ref)
    return got[2]


@pytest.mark.parametrize("b_exit", [False, True])
@pytest.mark.parametrize("kind", ["steane-dem", "random-wide"])
def test_k4_panel_decomposition_matches_plain_and_jax(rng, steane_dem, kind, b_exit):
    """K4's panels (staged words, masks with the permutation, the pivot
    triangle folded into the masks, the T update) bit for bit against
    ``eliminate_transform_plain``, the JAX lanes elimination and the Pallas
    kernel in interpret mode, on OSD's inputs: the BP failures."""
    H, syn, llrs, hard = _inputs(rng, kind, steane_dem, 96)
    _, order, resid = _system(H, syn, llrs, hard)
    live = resid.any(axis=1)
    order, resid = order[live][:16], resid[live][:16]
    stats = {}
    _hold_panels(H, order, resid, b_exit, stats)
    assert stats.get("swap", 0) > 0 and stats.get("pivot on the rank row", 0) > 0
    if kind == "random-wide":  # (the Steane DEM's 18 rows are all in the window from the rank)
        assert stats.get("rows outside the list", 0) > 0


def _edge_system(case: str, rng):
    """(H, order, resid, the stats keys the case must meet) for one of K4's
    edge cases; B = 8 samples, n = 301 (a last panel of 13 columns)."""
    B, n = 8, 301
    m = 64 if case == "m-multiple-of-32" else 40
    H = np.zeros((m, n), np.uint8)
    for j in range(n):
        H[rng.choice(m, size=rng.integers(1, 4), replace=False), j] = 1
    order = np.stack([rng.permutation(n) for _ in range(B)])
    need = ["swap", "pivot on the rank row"]
    if case == "full-rank":
        # H = [I | sparse]: rank(H) = m, reached inside a panel, and the
        # clamp of the rank row at m - 1 on every later column
        H[:, :m] = np.eye(m, dtype=np.uint8)
        need.append("rank(H) reached inside a panel")
    elif case == "identity-first":
        # the first 40 columns of every order are e_0, e_1, ...: each pivot
        # already on the rank row, no swap in the first panel
        H[:, :m] = np.eye(m, dtype=np.uint8)
        rest = np.stack([m + rng.permutation(n - m) for _ in range(B)])
        order = np.concatenate([np.tile(np.arange(m), (B, 1)), rest], axis=1)
        need = ["pivot on the rank row"]
    elif case == "empty-panel":
        # columns 32..71 of every order are zero columns: a panel without a
        # pivot, then a partial one
        H[:, 100:140] = 0
        rest = [c for c in range(n) if not 100 <= c < 140]
        order = np.stack([np.concatenate([(p := rng.permutation(rest))[:32], 100 + rng.permutation(40),
                                          p[32:]]) for _ in range(B)])
        need.append("panel without a pivot")
    elif case == "dense":
        # columns of weight about m/2: pivot rows that later pivots of the
        # same panel eliminate (RREF clears above); the kernel's list spans
        # two words and its swaps cross them
        H = (rng.random((m, n)) < 0.5).astype(np.uint8)
        need += ["pivot row eliminated later in its panel", "list over several words",
                 "swap across list words"]
    elif case == "last-panel":
        # row m - 1 is held by one column alone, placed last: the rank is
        # reached only in the last, partial panel
        H[m - 1] = 0
        H[m - 1, n - 1] = 1
        order = np.stack([np.append(rng.permutation(n - 1), n - 1) for _ in range(B)])
        need.append("partial panel")
    # half the samples a sum of a few columns early in their order (the
    # b-exit can take them at a panel boundary), half a random error's
    e = (rng.random((B, n)) < 0.05).astype(np.int64)
    for s in range(0, B, 2):
        e[s] = 0
        e[s, order[s, rng.choice(48, size=rng.integers(1, 4), replace=False)]] = 1
    if case == "last-panel":
        e[:, n - 1] = 1  # row m - 1's bit: not even the b-exit stops before the last panel
    resid = ((e @ H.T) % 2).astype(np.int64)
    resid[resid.sum(1) == 0, 0] = 1  # live samples, as OSD sees them
    return H, order, resid, need


@pytest.mark.parametrize("b_exit", [False, True])
@pytest.mark.parametrize("case", ["full-rank", "identity-first", "empty-panel", "dense",
                                  "last-panel", "m-multiple-of-32"])
def test_k4_panel_decomposition_on_edge_cases(rng, case, b_exit):
    """Each of K4's edge cases, met and held bit for bit against the plain
    version and both JAX references; with the b-exit, read on logical rows
    through the permutation, some samples leave early."""
    H, order, resid, need = _edge_system(case, rng)
    stats = {}
    rank = _hold_panels(H, order, resid, b_exit, stats)
    for key in need:
        assert stats.get(key, 0) > 0, (key, stats)
    if b_exit and case in ("dense", "m-multiple-of-32"):
        assert stats.get("b-exit", 0) > 0 and (rank < int(JaxOSDDecoder(H)._H_rank)).any()


@pytest.mark.parametrize("m,B,shape", [
    (432, 716, (256, 6, 1)),    # the [[72]] DEM's failures: six blocks an SM, one wave on 132 SMs
    (432, 4096, (256, 6, 6)),   # more than a wave
    (432, 1, (256, 1, 1)),      # one sample
    (864, 24, (512, 1, 1)),     # the space-time H_st failures: a block an SM
    (864, 716, (512, 2, 3)),    # two blocks an SM (114 KB of shared memory each)
    (1216, 64, (512, 1, 1)),    # 38 row groups: the largest instance, one block an SM
    (160, 4096, (160, 12, 3)),  # m = 5 words: a thread a row, as many blocks as threads allow
    (18, 64, (32, 1, 1)),       # the Steane DEM: one warp
])
def test_k4_launch_shape_follows_the_shapes(m, B, shape):
    """K4's threads a block, blocks an SM and waves from m, B and 132 SMs."""
    assert otc.launch_shape(m, B, 132) == shape
    threads, per_sm, _ = shape
    assert per_sm * threads <= otc._SM_THREADS
    assert per_sm * (otc.smem_bytes(m) + otc._STATIC_SMEM + 1024) <= otc._SM_SMEM
