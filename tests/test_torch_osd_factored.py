"""The port's factored elimination (plain torch) against the JAX package's
``FactoredEliminator`` run in interpret mode, as tests/test_osd_factored.py
runs it on the CPU.

Inputs come from numpy seeds: the random wide system of that file (40 x 640
with redundant rows) and the Steane memory-experiment DEM (18 x 267), with
consistent and inconsistent syndromes and nonzero BP hard decisions. Every
comparison is bit for bit:

  * each plain kernel function (K5a-d) against the JAX Pallas program it
    replaces, on the same state over a 128-lane slab, and torch renderings
    of the kernels' own decompositions (K5a's sparse product over column
    supports, K5c's column-major elimination with its bit transposes, K5d's
    L^-1 (E ^ G.P)) against both;
  * ``(b, pivoted, piv_col, overflow)`` against the JAX eliminator run one
    sample at a time, so that its slab's loop ends on that sample's own exit
    as the port's per-sample exit does;
  * the OSD-0 solutions against the JAX ``OSDDecoder`` with
    ``backend="factored"`` and with ``backend="lanes"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpc_tpu.codes import get_code
from qldpc_tpu.decoders.osd import OSDConfig as JaxOSDConfig
from qldpc_tpu.decoders.osd import OSDDecoder as JaxOSDDecoder
from qldpc_tpu.noise.circuit import memory_experiment_dem
from qldpc_tpu.ops.osd_factored import FactoredEliminator
from qldpc_tpu_torch.decoders import OSDConfig, OSDDecoder
from qldpc_tpu_torch.decoders import osd as port_osd
from qldpc_tpu_torch.ops import osd_factored_cuda as ofc

torch.set_num_threads(2)

WORD, K = 32, ofc.BLOCK_COLS


def _wide_case(rng, m=40, n=640, batch=8, density=0.05, err=0.02, redundant=3):
    """tests/test_osd_factored.py's wide case, with nonzero hard decisions."""
    H = (rng.random((m - redundant, n)) < density).astype(np.uint8)
    H[:, : m - redundant] |= np.eye(m - redundant, dtype=np.uint8)
    H = np.vstack([H, H[:redundant]])  # rank < m
    errors = (rng.random((batch, n)) < err).astype(np.int8)
    syndromes = ((errors.astype(np.int64) @ H.T) % 2).astype(np.int8)
    llrs = (rng.normal(size=(batch, n)) * 3.0).astype(np.float32)
    hard = (rng.random((batch, n)) < 0.03).astype(np.int8)
    return H, syndromes, llrs, hard


def _steane_case(rng, batch=8):
    dem = memory_experiment_dem(get_code("steane"), p=0.01, rounds=3)
    H = dem.H
    mech = (rng.random((batch, H.shape[1])) < dem.priors).astype(np.int64)
    syndromes = ((mech @ H.T) % 2).astype(np.int8)
    llrs = (dem.llrs[None, :] + rng.normal(size=(batch, H.shape[1])) * 2.0).astype(np.float32)
    hard = (llrs < 0).astype(np.int8)
    return H, syndromes, llrs, hard


CASES = {"random-wide": _wide_case, "steane-dem": _steane_case}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    rng = np.random.default_rng(20260820)
    H, syn, llrs, hard = CASES[request.param](rng)
    jdec = JaxOSDDecoder(H, JaxOSDConfig(order=0, backend="factored"))
    return dict(H=H, syn=syn, llrs=llrs, hard=hard, h_rank=jdec._H_rank,
                max_cols=max(2048, min(H.shape[1], jdec._H_rank + 512)), jdec=jdec)


def _system(case, inconsistent):
    """(order, resid) as both decoders build them, the residual flipped on
    one row per sample to make an inconsistent system."""
    H, syn, llrs, hard = case["H"], case["syn"], case["llrs"], case["hard"]
    resid = (syn.astype(np.int64) + hard.astype(np.int64) @ H.T) % 2
    if inconsistent:
        resid[np.arange(len(resid)), np.arange(len(resid)) % H.shape[0]] ^= 1
    order = np.argsort(np.abs(llrs), axis=1, kind="stable").astype(np.int32)
    return order, resid.astype(np.int32)


def _port(case, order, resid, max_cols):
    out = ofc.eliminate_factored(
        torch.from_numpy(order), torch.from_numpy(resid),
        torch.from_numpy(ofc.factored_columns(case["H"])), case["h_rank"], max_cols)
    return tuple(t.numpy() for t in out)


def _jax_per_sample(case, order, resid, max_cols):
    elim = FactoredEliminator(case["H"], h_rank=case["h_rank"], max_cols=max_cols,
                              interpret=True)
    one = jax.jit(elim.__call__)
    outs = [one(jnp.asarray(order[i: i + 1]), jnp.asarray(resid[i][:, None], jnp.uint32))
            for i in range(len(order))]
    b, piv, piv_col = (np.concatenate([np.asarray(o[k]).T for o in outs]) for k in range(3))
    overflow = np.concatenate([np.asarray(o[3]) for o in outs])
    return b, piv, piv_col, overflow


@pytest.mark.parametrize("inconsistent", [False, True])
def test_elimination_matches_jax_per_sample(case, inconsistent):
    order, resid = _system(case, inconsistent)
    got = _port(case, order, resid, case["max_cols"])
    ref = _jax_per_sample(case, order, resid, case["max_cols"])
    for name, g, r in zip(("b", "pivoted", "piv_col", "overflow"), got, ref):
        assert np.array_equal(g.astype(np.int64), r.astype(np.int64)), name
    assert not got[3].any()
    # each pivot column is an original column id on a pivoted row
    assert ((got[2] >= 0) == (got[1] == 1)).all()


@pytest.mark.parametrize("inconsistent", [False, True])
def test_osd0_solutions_match_jax_backends(case, inconsistent):
    H, llrs, hard = case["H"], case["llrs"], case["hard"]
    _, resid = _system(case, inconsistent)
    syn = ((resid + hard.astype(np.int64) @ H.T) % 2).astype(np.int8)
    dec = OSDDecoder(H, OSDConfig(backend="factored"))
    assert dec.elimination == "factored"
    got = dec(torch.from_numpy(syn), torch.from_numpy(llrs), torch.from_numpy(hard)).numpy()
    ref = case["jdec"](syn, llrs, hard)  # the JAX factored backend
    assert np.array_equal(got, np.asarray(ref))
    lanes = JaxOSDDecoder(H, JaxOSDConfig(order=0, backend="lanes"))(syn, llrs, hard)
    assert np.array_equal(got, np.asarray(lanes))


@pytest.fixture(scope="module")
def low_rank_first():
    """A wide system whose 200 least reliable columns touch rows 0-9 only:
    a budget of one block reaches rank 10 at most, below rank(H), and every
    syndrome with a bit outside rows 0-9 is left unresolved."""
    rng = np.random.default_rng(11)
    H, syn, llrs, hard = _wide_case(rng)
    H[10:, :200] = 0
    llrs[:, :200] = 0.01 * np.sign(llrs[:, :200])
    syn = ((rng.random(syn.shape) < 0.3) | (np.arange(H.shape[0]) == 20)).astype(np.int8)
    jdec = JaxOSDDecoder(H, JaxOSDConfig(order=0, backend="factored"))
    return dict(H=H, syn=syn, llrs=llrs, hard=hard, h_rank=jdec._H_rank)


def test_small_budget_overflows_like_jax(low_rank_first):
    case = low_rank_first
    order, resid = _system(case, inconsistent=False)
    got = _port(case, order, resid, max_cols=K)
    ref = _jax_per_sample(case, order, resid, max_cols=K)
    for name, g, r in zip(("b", "pivoted", "piv_col", "overflow"), got, ref):
        assert np.array_equal(g.astype(np.int64), r.astype(np.int64)), name
    assert got[3].all()


def test_overflow_lanes_return_hard(low_rank_first):
    case = low_rank_first
    H, syn, llrs, hard = case["H"], case["syn"], case["llrs"], case["hard"]
    dec = OSDDecoder(H, OSDConfig(backend="factored"))
    assert dec.max_cols == max(2048, min(H.shape[1], dec.h_rank + 512))
    dec.max_cols = K  # below the decoder's own floor of rank + 512
    got = dec(torch.from_numpy(syn), torch.from_numpy(llrs), torch.from_numpy(hard)).numpy()
    assert np.array_equal(got, hard)
    jdec = JaxOSDDecoder(H, JaxOSDConfig(order=0, backend="factored"))
    jdec._factored = FactoredEliminator(H, h_rank=jdec._H_rank, max_cols=K, interpret=True)
    assert np.array_equal(got, np.asarray(jdec(syn, llrs, hard)))


# ------------------------------------------------- each kernel's plain version
@pytest.fixture(scope="module")
def slab():
    """A random mid-elimination state of 128 lanes of the random wide system
    in both layouts: the JAX one (lanes minor, rows padded to 256) and the
    port's (sample-major, rows padded to 32)."""
    rng = np.random.default_rng(7)
    H = _wide_case(rng)[0]
    m, n = H.shape
    B, blk = 128, 2
    scur = blk * K
    elim = FactoredEliminator(H, h_rank=37, max_cols=n, interpret=True)
    progs = elim._progs(B)
    hc_p = ofc.factored_columns(H)  # (n + 1, mw)
    mw = hc_p.shape[1]
    m_pad = mw * WORD
    s_max, cw = elim.s_max, elim.cw
    u32 = lambda *shape: rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    row_mask = np.uint32((1 << (m - WORD)) - 1)  # rows >= m stay zero
    P = u32(B, s_max, mw)
    P[:, :, -1] &= row_mask
    P[:, scur:] = 0
    C = u32(B, cw, m_pad) & (rng.random((B, cw, m_pad)) < 0.5)
    C[:, :, m:] = 0
    C[:, (scur + K) // WORD:] = 0
    ids = rng.integers(0, n + 1, size=(B, K)).astype(np.int32)  # n: the sentinel
    return dict(H=H, m=m, n=n, B=B, blk=blk, scur=scur, progs=progs, elim=elim,
                Hc=hc_p, mw=mw, m_pad=m_pad, P=P, C=C, ids=ids, rng=rng)


def _jax_rows(x, rows):
    """Port words (..., mw) -> JAX words (..., mw_jax): rows padded to 256."""
    pad = rows // WORD - x.shape[-1]
    return np.concatenate([x, np.zeros(x.shape[:-1] + (pad,), x.dtype)], axis=-1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _lanes(s):
    return torch.from_numpy(np.sort(s["rng"].choice(s["B"], 48, replace=False)).astype(np.int32))


def test_y_plain_matches_pallas(slab):
    s = slab
    y_prog = s["progs"][0]
    hblk = np.asarray(s["elim"]._Hc)[s["ids"]].transpose(1, 2, 0)  # (K, mw_jax, B)
    P_j = _jax_rows(s["P"], s["elim"].m_pad).transpose(1, 2, 0)
    Y_j = np.asarray(y_prog(jnp.array([s["scur"]], jnp.int32), P_j, hblk))
    lanes = _lanes(s)
    got = ofc.factored_y_plain(_t(s["P"]), lanes, _t(s["ids"][lanes.numpy()]), _t(s["Hc"]), s["scur"])
    ref = Y_j[: s["scur"]].transpose(2, 0, 1)[lanes.numpy()]
    assert np.array_equal(got.numpy().view(np.uint32), ref)


def test_w_plain_matches_pallas(slab):
    s = slab
    scur, B = s["scur"], s["B"]
    y_prog, w_prog = s["progs"][:2]
    Y_p = s["rng"].integers(0, 2**32, size=(B, scur, K // WORD), dtype=np.uint64).astype(np.uint32)
    Y_j = np.zeros((s["elim"].s_max, K // WORD, B), np.uint32)
    Y_j[:scur] = Y_p.transpose(1, 2, 0)
    C_j = np.zeros((s["elim"].m_pad, s["elim"].cw, B), np.uint32)
    C_j[: s["m_pad"]] = s["C"].transpose(2, 1, 0)
    hblk_t = np.asarray(s["elim"]._Hc)[s["ids"]].transpose(2, 1, 0)  # (mw_jax, K, B)
    W_j = np.asarray(w_prog(jnp.array([scur], jnp.int32), C_j, Y_j, hblk_t))
    lanes = _lanes(s)
    got = ofc.factored_w_plain(_t(s["C"]), lanes, _t(s["ids"][lanes.numpy()]), _t(s["Hc"]),
                         _t(Y_p[lanes.numpy()]), scur)
    ref = W_j[: s["m_pad"]].transpose(2, 0, 1)[lanes.numpy()]
    assert np.array_equal(got.numpy().view(np.uint32), ref)


@pytest.fixture(scope="module")
def panel(slab):
    """K5c on the slab in both packages: the JAX Pallas program and the
    port's plain version, on the same W, b and pivoted flags."""
    s = slab
    rng, B, m, m_pad, mw, blk = (s[k] for k in ("rng", "B", "m", "m_pad", "mw", "blk"))
    elim_prog = s["progs"][2]
    W = rng.integers(0, 2**32, size=(B, m_pad, K // WORD), dtype=np.uint64).astype(np.uint32)
    W[:, m:] = 0
    bits = lambda p: (rng.random((B, m_pad)) < p) & (np.arange(m_pad) < m)
    pack = lambda x: np.packbits(x.reshape(B, mw, WORD), axis=-1, bitorder="little").view(np.uint32)[..., 0]
    b0, piv0 = pack(bits(0.5)), pack(bits(0.3))
    mj = s["elim"].m_pad
    W_j = np.zeros((mj, K // WORD, B), np.uint32)
    W_j[:m_pad] = W.transpose(1, 2, 0)
    jax_out = tuple(map(np.asarray, elim_prog(
        jnp.asarray(s["ids"].T), W_j, _jax_rows(b0, mj).T, _jax_rows(piv0, mj).T)))

    lanes = _lanes(s)
    ln = lanes.numpy()
    b_t, piv_t, C_t = _t(b0.copy()), _t(piv0.copy()), _t(s["C"].copy())
    prow = ofc.factored_panel_elim_plain(_t(W[ln]), b_t, piv_t, C_t, lanes, _t(s["ids"][ln]), s["n"], blk)
    return dict(jax=jax_out, lanes=lanes, prow=prow, b=b_t, piv=piv_t, C=C_t)


def _jax_resolve(s, C, lanes, prow, blk):
    """The JAX ``_resolve_kernel`` (interpret mode) on the slab's P and the
    port's C: G and D are the pivots' rows of C, masked where a column has
    no pivot, as the JAX slab loop gathers them. Returns the new P rows of
    ``lanes`` in the port's layout, (A, K, mw) uint32."""
    mj, m_pad, B = s["elim"].m_pad, s["m_pad"], s["B"]
    ln = lanes.numpy()
    C_j = np.zeros((mj, s["elim"].cw, B), np.uint32)
    C_j[:m_pad] = C.numpy().view(np.uint32).transpose(2, 1, 0)
    prow_all = np.full((K, B), mj, np.int32)
    prow_all[:, ln] = np.where(prow.numpy() == m_pad, mj, prow.numpy()).T
    valid = prow_all < mj
    pcl = np.minimum(prow_all, mj - 1)[:, None, :]
    G = np.where(valid[:, None, :], np.take_along_axis(C_j, pcl, axis=0), 0)
    D = np.where(valid[:, None, :], np.take_along_axis(C_j[:, blk * 4: blk * 4 + 4], pcl, axis=0), 0)
    P_j = _jax_rows(s["P"], mj).transpose(1, 2, 0)
    Pnew_j = np.asarray(s["progs"][3](jnp.array([blk * K], jnp.int32), P_j, G, D, prow_all))
    return Pnew_j[:, : s["mw"]].transpose(2, 0, 1)[ln]


def test_panel_elim_and_resolve_plain_match_pallas(slab, panel):
    s, pn = slab, panel
    B, m_pad, mw, blk, scur = (s[k] for k in ("B", "m_pad", "mw", "blk", "scur"))
    b_j, piv_j, cnew_j, prow_j = pn["jax"]
    lanes, prow, b_t, piv_t, C_t = (pn[k] for k in ("lanes", "prow", "b", "piv", "C"))
    ln = lanes.numpy()
    mj = s["elim"].m_pad
    # JAX marks "no pivot" with its own m_pad
    assert np.array_equal(np.where(prow.numpy() == m_pad, mj, prow.numpy()), prow_j.T[ln])
    assert np.array_equal(b_t.numpy().view(np.uint32)[ln], b_j.T[ln, :mw])
    assert np.array_equal(piv_t.numpy().view(np.uint32)[ln], piv_j.T[ln, :mw])
    cnew = C_t.numpy().view(np.uint32)[ln, blk * 4: blk * 4 + 4]  # (A, kw, m_pad)
    assert np.array_equal(cnew, cnew_j[:m_pad].transpose(2, 1, 0)[ln])
    others = np.ones(B, bool)
    others[ln] = False
    assert np.array_equal(C_t.numpy().view(np.uint32)[others], s["C"][others])

    # K5d on that state
    P_t = _t(s["P"].copy())
    ofc.factored_resolve_plain(P_t, C_t, lanes, prow, blk)
    P_out = P_t.numpy().view(np.uint32)
    assert np.array_equal(P_out[ln, scur: scur + K], _jax_resolve(s, C_t, lanes, prow, blk))
    assert np.array_equal(P_out[ln, :scur], s["P"][ln, :scur])
    assert np.array_equal(P_out[others], s["P"][others])


# ------------------------------------------------- K5d's triangle-free form
def _resolve_decomposed(P, C, lanes, prow, blk: int) -> None:
    """K5d as its kernel computes it, in plain torch: with N the strictly
    lower part of the block's D (rows without a pivot zero) and L = I ^ N,
    L^-1 by forward substitution in pivot order (row j2 is final once the
    rows before it are applied, and goes to every later row j with
    N[j, j2], as the kernel's warp broadcasts it), then
    ``P_new = L^-1 (E ^ G.P)`` into ``P[lanes, blk * K: (blk + 1) * K]``."""
    lanes_l = lanes.long()
    A, m_pad, scur = prow.shape[0], C.shape[2], blk * K
    valid = prow < m_pad
    pcl = prow.long().clamp(max=m_pad - 1)
    Cl = C[lanes_l]
    rows = torch.gather(Cl, 2, pcl[:, None, :].expand(-1, Cl.shape[1], -1)) * valid[:, None, :]
    N = torch.tril(ofc._unpack(rows[:, blk * 4: (blk + 1) * 4].transpose(1, 2)), diagonal=-1)
    Linv = torch.eye(K, dtype=torch.int32).repeat(A, 1, 1)
    for j2 in range(K):
        Linv ^= N[:, :, j2, None] * Linv[:, j2, None, :]
    X = torch.zeros((A, K, m_pad), dtype=torch.int32)
    if scur:
        G = ofc._unpack(rows[:, : scur // WORD].transpose(1, 2))
        X = ofc._gf2_mm(G, ofc._unpack(P[lanes_l, :scur]))
    X.scatter_(2, pcl[:, :, None], X.gather(2, pcl[:, :, None]) ^ valid[:, :, None].to(torch.int32))
    P[lanes_l, scur: scur + K] = ofc._pack(ofc._gf2_mm(Linv, X))


@pytest.mark.parametrize("case", ["panel", "first-block", "no-pivot", "upper-bits"])
def test_resolve_decomposition_matches_plain_and_pallas(slab, panel, case):
    """L^-1 (E ^ G.P) bit for bit against ``factored_resolve_plain`` and the
    JAX kernel: on K5c's own output, at block 0 (no G.P), at a block where
    no column has a pivot, and with dense C words, whose bits above D's
    diagonal must be masked as the JAX kernel masks them."""
    s = slab
    rng, m_pad = np.random.default_rng(41), s["m_pad"]
    lanes, C, blk = panel["lanes"], panel["C"], s["blk"]
    prow = panel["prow"]
    if case != "panel":
        # distinct pivot rows on 30 of the block's columns, as many as the
        # system's 40 rows allow
        prow = np.full((lanes.shape[0], K), m_pad, np.int32)
        for row in prow:
            row[rng.choice(K, 30, replace=False)] = rng.permutation(s["m"])[:30]
        C = s["C"].copy()
        if case == "first-block":
            blk = 0
        if case == "no-pivot":
            prow[:] = m_pad
        if case == "upper-bits":
            C[:, blk * 4: blk * 4 + 4, : s["m"]] = rng.integers(
                0, 2**32, size=(s["B"], 4, s["m"]), dtype=np.uint64).astype(np.uint32)
        prow, C = torch.from_numpy(prow), _t(C)
    scur = blk * K
    if case == "upper-bits":
        D = ofc._unpack(C[lanes.long()][:, blk * 4: blk * 4 + 4].transpose(1, 2))
        assert int(torch.triu(D).sum()) > 0
    got, ref = _t(s["P"].copy()), _t(s["P"].copy())
    _resolve_decomposed(got, C, lanes, prow, blk)
    ofc.factored_resolve_plain(ref, C, lanes, prow, blk)
    assert torch.equal(got, ref)
    new = got.numpy().view(np.uint32)[lanes.numpy(), scur: scur + K]
    assert np.array_equal(new, _jax_resolve(s, C, lanes, prow, blk))
    assert bool(new.any()) == (case != "no-pivot")


# ------------------------------------- K5c's column-major form, K5a's supports
_LO = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)
_U32 = 0xFFFFFFFF


def _u(words: torch.Tensor) -> torch.Tensor:
    """int32 words holding uint32 patterns -> int64 in [0, 2**32)."""
    return words.to(torch.int64) & _U32


def _i32(words: torch.Tensor) -> torch.Tensor:
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _transpose32(x: torch.Tensor) -> torch.Tensor:
    """The kernels' five-step butterfly over the lane axis (last, 32 long):
    step s swaps lane-index bit s with bit-index bit s, each lane taking
    its partner's word as __shfl_xor_sync gives it."""
    lane = torch.arange(WORD)
    for k, lo in enumerate(_LO):
        s, hi = 16 >> k, lo ^ _U32
        y = x[..., lane ^ s]
        x = torch.where((lane & s) != 0, (x & hi) | ((y & hi) >> s),
                        (x & lo) | (((y & lo) << s) & _U32))
    return x


def _panel_elim_decomposed(W, b, piv, C, lanes, ids, n: int, blk: int) -> torch.Tensor:
    """K5c as its kernel computes it, in plain torch: W transposed into
    column masks over rows (one 32 x 32 butterfly per word group); per
    column j the pivot is the lowest set bit of col_j & ~piv, row p's bits
    are bit p of every column, M = col_j ^ e_p goes to every later column
    holding bit p (earlier ones are never read again) and to b where b_p is
    set, and overwrites col_j as C's new column j; the masks are transposed
    back into C's row words. Same contract as ``factored_panel_elim_plain``."""
    lanes_l = lanes.long()
    A, m_pad, kw = W.shape
    mw = m_pad // WORD
    aidx, cols_after = torch.arange(A), torch.arange(K)
    # lane l of word group g holds row 32 g + l; after it, lane i column 32 q + i
    x = _u(W).reshape(A, mw, WORD, kw).permute(0, 3, 1, 2)  # (A, q, g, lane)
    cols = _transpose32(x).permute(0, 1, 3, 2).reshape(A, K, mw)  # (A, j, g)
    bw, pw = _u(b[lanes_l]), _u(piv[lanes_l])
    prow = torch.full((A, K), m_pad, dtype=torch.int32)
    for j in range(K):
        c = cols[:, j]
        cand = c & ~pw & _U32
        has = (cand != 0).any(1) & (ids[:, j] < n)
        g = (cand != 0).to(torch.int8).argmax(1)  # the first word holding a candidate
        low = cand[aidx, g] & -cand[aidx, g]
        bit = torch.log2(low.clamp(min=1).double()).round().long()
        e = torch.zeros_like(c)
        e[aidx, g] = torch.where(has, low, 0)
        M = torch.where(has[:, None], c ^ e, 0)
        rowp = (cols[aidx, :, g] >> bit[:, None]) & 1  # bit p of every column
        upd = (rowp == 1) & (cols_after > j)[None, :] & has[:, None]
        cols = torch.where(upd[:, :, None], cols ^ M[:, None, :], cols)
        bp = ((bw[aidx, g] >> bit) & 1) == 1
        bw = torch.where((has & bp)[:, None], bw ^ M, bw)
        pw = pw | e
        cols[:, j] = M
        prow[:, j] = torch.where(has, g * WORD + bit, m_pad).to(torch.int32)
    # lane i holds column 32 q + i's word g; after it, lane l row 32 g + l's word q
    y = cols.reshape(A, kw, WORD, mw).permute(0, 1, 3, 2)  # (A, q, g, lane)
    C[lanes_l, blk * kw: (blk + 1) * kw] = _i32(_transpose32(y).reshape(A, kw, m_pad))
    b[lanes_l], piv[lanes_l] = _i32(bw), _i32(pw)
    return prow


def test_butterfly_is_the_bit_transpose():
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 2**32, size=(3, WORD)))
    got = ofc._unpack(_i32(_transpose32(x)))  # (3, lane i, bit l)
    ref = ofc._unpack(_i32(x)).reshape(3, WORD, WORD).transpose(1, 2).reshape(3, -1)
    assert torch.equal(got, ref)


def _panel_case(s, case: str):
    """W, b, pivoted flags and column ids of all the slab's lanes for one
    K5c case: "random" (the slab's ids, a sentinel now and then),
    "sentinel" (every other column a sentinel), "no-candidate" (column 0
    held by pivoted rows alone, every eighth column from 4 empty), "all-pivoted"
    (every row of the system pivoted) and "dense" (W rows 90% set)."""
    rng = np.random.default_rng(61 + sorted(PANEL_CASES).index(case))
    B, m, m_pad, mw, n = (s[k] for k in ("B", "m", "m_pad", "mw", "n"))
    in_rows = np.arange(m_pad) < m
    W = rng.integers(0, 2**32, size=(B, m_pad, K // WORD), dtype=np.uint64).astype(np.uint32)
    if case == "dense":
        W |= rng.integers(0, 2**32, size=W.shape, dtype=np.uint64).astype(np.uint32)
        W |= rng.integers(0, 2**32, size=W.shape, dtype=np.uint64).astype(np.uint32)
    W[:, ~in_rows] = 0
    b_bits = (rng.random((B, m_pad)) < 0.5) & in_rows
    piv_bits = ((rng.random((B, m_pad)) < 0.3) | (case == "all-pivoted")) & in_rows
    ids = s["ids"].copy()
    if case == "sentinel":
        ids[:, ::2] = n
    if case == "no-candidate":
        W[:, :, 0] = np.where(piv_bits, W[:, :, 0], W[:, :, 0] & ~np.uint32(1))
        for j in range(4, K, 8):
            W[:, :, j // WORD] &= ~np.uint32(1 << (j % WORD))
    pack = lambda x: np.packbits(x.reshape(B, mw, WORD), axis=-1, bitorder="little").view(np.uint32)[..., 0]
    return W, pack(b_bits), pack(piv_bits), ids


PANEL_CASES = ("random", "sentinel", "no-candidate", "all-pivoted", "dense")


@pytest.mark.parametrize("case", PANEL_CASES)
def test_panel_elim_decomposition_matches_plain_and_pallas(slab, case):
    """K5c's column-major elimination bit for bit against
    ``factored_panel_elim_plain`` and the JAX ``_elim_kernel`` (interpret
    mode) on 48 lanes of the slab."""
    s = slab
    W, b0, piv0, ids = _panel_case(s, case)
    mj, m_pad, blk, B = s["elim"].m_pad, s["m_pad"], s["blk"], s["B"]
    W_j = np.zeros((mj, K // WORD, B), np.uint32)
    W_j[:m_pad] = W.transpose(1, 2, 0)
    b_j, piv_j, cnew_j, prow_j = map(np.asarray, s["progs"][2](
        jnp.asarray(ids.T), W_j, _jax_rows(b0, mj).T, _jax_rows(piv0, mj).T))
    lanes = _lanes(s)
    ln = lanes.numpy()
    outs = []
    for fn in (_panel_elim_decomposed, ofc.factored_panel_elim_plain):
        b_t, piv_t, C_t = _t(b0.copy()), _t(piv0.copy()), _t(s["C"].copy())
        prow = fn(_t(W[ln]), b_t, piv_t, C_t, lanes, _t(ids[ln]), s["n"], blk)
        outs.append((prow, b_t, piv_t, C_t))
    for got, ref in zip(*outs):
        assert torch.equal(got, ref)
    prow, b_t, piv_t, C_t = outs[0]
    assert np.array_equal(np.where(prow.numpy() == m_pad, mj, prow.numpy()), prow_j.T[ln])
    assert np.array_equal(b_t.numpy().view(np.uint32)[ln], b_j.T[ln, : s["mw"]])
    assert np.array_equal(piv_t.numpy().view(np.uint32)[ln], piv_j.T[ln, : s["mw"]])
    cnew = C_t.numpy().view(np.uint32)[ln, blk * 4: blk * 4 + 4]
    assert np.array_equal(cnew, cnew_j[:m_pad].transpose(2, 1, 0)[ln])
    pivots = int((prow < m_pad).sum())
    if case == "all-pivoted":
        assert pivots == 0 and not cnew.any()
    else:
        assert pivots > 0
    if case == "no-candidate":
        assert (prow[:, 4::8] == m_pad).all() and (prow[:, 0] == m_pad).all()
    if case == "sentinel":
        assert (prow[:, ::2] == m_pad).all()


def _y_decomposed(P, lanes, ids, Hc, scur: int) -> torch.Tensor:
    """K5a as its kernel computes it, in plain torch: each block column's
    support as a compact list of its nonzero words (index and mask, in
    ascending order, a sentinel column's list empty), then bit k of Y[s]
    the parity of the XOR of P[s][w] & mask over column k's list. Same
    contract as ``factored_y_plain``."""
    cols = _u(Hc[ids.long()])  # (A, K, mw)
    nz = cols != 0
    cnt = nz.sum(2)
    L = max(int(cnt.max()), 1)
    widx = torch.sort(nz.to(torch.int8), dim=2, descending=True, stable=True).indices[..., :L]
    mask = torch.gather(cols, 2, widx) * (torch.arange(L) < cnt[..., None])
    Pl = _u(P[lanes.long(), :scur])  # (A, scur, mw)
    x = torch.zeros((Pl.shape[0], scur, K), dtype=torch.int64)
    for i in range(L):
        x ^= torch.gather(Pl, 2, widx[:, None, :, i].expand(-1, scur, -1)) & mask[:, None, :, i]
    for sh in (16, 8, 4, 2, 1):
        x ^= x >> sh
    return ofc._pack(x & 1)


@pytest.mark.parametrize("case", ["slab", "sentinel", "heavy", "first-block"])
def test_y_decomposition_matches_plain_and_pallas(slab, case):
    """K5a's sparse product over column supports bit for bit against
    ``factored_y_plain`` and the JAX ``_y_kernel`` (interpret mode): the
    slab's state, every other column a sentinel (empty support), a heavy
    column (every row of the system) and scur = 128, the first block K5a
    runs."""
    s = slab
    ids, Hc, scur = s["ids"].copy(), s["Hc"].copy(), s["scur"]
    if case == "sentinel":
        ids[:, ::2] = s["n"]
    if case == "heavy":
        heavy = 7  # a column of H set on every row of the system
        ids[:, [5, 77]] = heavy
        Hc[heavy, 0] = -1  # rows 0-31
        Hc[heavy, 1] = (1 << (s["m"] - WORD)) - 1  # rows 32 .. m - 1
    if case == "first-block":
        scur = K
    mj, B = s["elim"].m_pad, s["B"]
    hblk = _jax_rows(Hc.view(np.uint32)[ids], mj).transpose(1, 2, 0)  # (K, mw_jax, B)
    P_j = _jax_rows(s["P"], mj).transpose(1, 2, 0)
    Y_j = np.asarray(s["progs"][0](jnp.array([scur], jnp.int32), P_j, hblk))
    lanes = _lanes(s)
    ln = lanes.numpy()
    args = (_t(s["P"]), lanes, _t(ids[ln]), _t(Hc), scur)
    got, ref = _y_decomposed(*args), ofc.factored_y_plain(*args)
    assert torch.equal(got, ref)
    assert np.array_equal(got.numpy().view(np.uint32), Y_j[:scur].transpose(2, 0, 1)[ln])
    assert got.shape == (48, scur, K // WORD) and bool(got.ne(0).any())
    if case == "sentinel":
        assert not (ofc._unpack(got)[..., ::2]).any()


def _w_decomposed(C, lanes, ids, Hc, Y, scur: int, rows: int) -> torch.Tensor:
    """K5b as its kernel computes it, in plain torch, tile by tile of
    ``rows`` rows: bit k of W set in the rows of the set bits of block
    column k's words over the tile (each word read once), then each row's
    coefficient words walked bit by bit, lowest first, XORing in the Y row
    of each set bit. Same contract as ``factored_w_plain``."""
    A, m_pad = lanes.shape[0], C.shape[2]
    cols = _u(Hc[ids.long()])  # (A, K, mw)
    Cl = _u(C[lanes.long(), : scur // WORD])  # (A, sw, m_pad)
    Yl = _u(Y)  # (A, scur, 4)
    aidx = torch.arange(A)[:, None]
    tiles = []
    for r0 in range(0, m_pad, rows):
        nr = min(rows, m_pad - r0)
        H = torch.zeros((A, nr, K // WORD), dtype=torch.int64)
        words = cols[:, :, r0 // WORD: (r0 + nr) // WORD]  # (A, K, nr / 32)
        for b in range(WORD):  # the walk over each word's set bits, in any order
            hit = ((words >> b) & 1).transpose(1, 2)  # (A, nr / 32, K): row 32 w + b
            for q in range(K // WORD):
                H[:, b::WORD, q] |= (hit[:, :, WORD * q: WORD * (q + 1)]
                                     << torch.arange(WORD)).sum(-1)
        acc = torch.zeros((A, nr, K // WORD), dtype=torch.int64)
        for sw in range(scur // WORD):
            x = Cl[:, sw, r0: r0 + nr].clone()
            while bool(x.any()):
                low = x & -x
                s = torch.log2(low.clamp(min=1).double()).round().long()
                y = Yl[aidx, WORD * sw + s]  # (A, nr, 4)
                acc ^= torch.where((x != 0)[..., None], y, 0)
                x &= x - 1
        tiles.append(acc ^ H)
    return _i32(torch.cat(tiles, dim=1))


@pytest.mark.parametrize("case", ["slab", "sparse", "zero", "sentinel-heavy"])
@pytest.mark.parametrize("rows", [32, 2048])
def test_w_decomposition_matches_plain_and_pallas(slab, case, rows):
    """K5b's H bits from the block columns' words and its set-bit walk of C
    bit for bit against ``factored_w_plain`` and the JAX ``_w_kernel``
    (interpret mode) on 48 lanes of the slab: the slab's C (half its bits
    set), C as sparse as the [[144]] DEM's (0.2%), C zero, and every other
    column a sentinel with two heavy columns, at the smallest and the
    largest tile."""
    s = slab
    scur, B, m = s["scur"], s["B"], s["m"]
    rng = np.random.default_rng(81 + len(case))
    C, ids, Hc = s["C"].copy(), s["ids"].copy(), s["Hc"].copy()
    if case == "sparse":
        C &= np.where(rng.random(C.shape) < 0.06, rng.integers(0, 2**32, C.shape, dtype=np.uint64)
                      & rng.integers(0, 2**32, C.shape, dtype=np.uint64)
                      & rng.integers(0, 2**32, C.shape, dtype=np.uint64), 0).astype(np.uint32)
    if case == "zero":
        C[:] = 0
    if case == "sentinel-heavy":
        ids[:, ::2] = s["n"]
        ids[:, [5, 77]] = 7
        Hc[7, 0] = -1
        Hc[7, 1] = (1 << (m - WORD)) - 1
    Y_p = rng.integers(0, 2**32, size=(B, scur, K // WORD), dtype=np.uint64).astype(np.uint32)
    Y_j = np.zeros((s["elim"].s_max, K // WORD, B), np.uint32)
    Y_j[:scur] = Y_p.transpose(1, 2, 0)
    C_j = np.zeros((s["elim"].m_pad, s["elim"].cw, B), np.uint32)
    C_j[: s["m_pad"]] = C.transpose(2, 1, 0)
    hblk_t = _jax_rows(Hc.view(np.uint32)[ids], s["elim"].m_pad).transpose(2, 1, 0)
    W_j = np.asarray(s["progs"][1](jnp.array([scur], jnp.int32), C_j, Y_j, hblk_t))
    lanes = _lanes(s)
    ln = lanes.numpy()
    args = (_t(C), lanes, _t(ids[ln]), _t(Hc), _t(Y_p[ln]), scur)
    got, ref = _w_decomposed(*args, rows=rows), ofc.factored_w_plain(*args)
    assert torch.equal(got, ref)
    assert np.array_equal(got.numpy().view(np.uint32), W_j[: s["m_pad"]].transpose(2, 0, 1)[ln])
    if case == "zero":  # W is the block columns' bits of H
        assert torch.equal(got, ofc.factored_w_plain(*args[:5], 0))


@pytest.mark.parametrize("A,m_pad,rows", [
    (1017, 1728, 2048), (720, 1728, 2048), (384, 1728, 2048), (172, 1728, 1024),
    (75, 1728, 512), (28, 1728, 128), (13, 1728, 64), (1, 1728, 32), (1017, 5184, 2048),
    (20, 32, 32), (300, 96, 128)])
def test_w_tile_follows_the_samples(A, m_pad, rows):
    """K5b's tile on 132 SMs: the whole sample while the samples give two
    blocks an SM, then smaller tiles, never larger than a sample needs."""
    assert ofc.w_tile_rows(A, m_pad, 132) == rows


def test_elimination_choice_follows_the_shape(case, monkeypatch):
    H = case["H"]
    assert OSDDecoder(H).elimination == "transform"  # its transform fits K4
    monkeypatch.setattr(port_osd, "SMEM_LIMIT", 0)
    # the factored elimination, then the transform past its budget
    assert OSDDecoder(H).elimination == "factored+transform"
    assert OSDDecoder(H, OSDConfig(backend="factored")).elimination == "factored"
    narrow = get_code("steane").Hx
    assert OSDDecoder(narrow).elimination == "rows"
    with pytest.raises(ValueError, match="wide systems"):
        OSDDecoder(narrow, OSDConfig(backend="factored"))
    with pytest.raises(ValueError, match="unknown OSD backend"):
        OSDConfig(backend="lanes")


def test_kernel_wrappers_refuse_cpu_tensors():
    cpu = torch.zeros((1, 2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        ofc.factored_y_cuda(cpu, cpu[0, 0], cpu[0], cpu[0], 0)
    meta = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ofc.eliminate_factored(meta, meta, meta, 1, 128)
