// Transform GF(2) elimination past K4's block (K4g): a sample on a cluster
// of C blocks, pivot-first panels.
//
// Computes qldpc_tpu/decoders/osd.py::_eliminate_lanes_T, the JAX package's
// XLA transform elimination of wide systems (not a Pallas kernel: the TPU
// kernel K4 replaces, osd_transform_pallas.py::_kernel, keeps a tile of T
// in VMEM and the JAX decoder leaves it past about 6 MB). It is K4's
// algorithm (gf2_transform_elim.cu: panels of 32 columns, the panel's bits
// of every row on one word, one warp eliminating the panel, T updated once
// a panel from the pivots' panel-start rows U) for systems whose T does not
// fit one block's shared memory: 373 KB a sample at the [[144,12,12]] DEM
// (1,728 rows), 840 KB at [[288,12,18]] space-time (2,592 rows), 3.36 MB at
// the [[288,12,18]] DEM (5,184 rows), against 227 KB.
//
// What bounds it on the card: the chain of panels of one sample, each
// reading the rows of T where a panel column is nonzero and rewriting the
// rows a pivot eliminates. Lanes outside H's image walk to rank(H): 10^4 to
// 10^5 columns, most panels with no pivot once the rank is near rank(H).
// The design:
//
// * A cluster of C blocks a sample (``cg::this_cluster``). Slot r (T's row
//   r; logical row i lives in slot pslot[i], a swap moves pslot, not data)
//   belongs to block r / R, R = ceil(m / C), for the whole walk: each block
//   computes its slots' panel words and applies the row operations to its
//   slots. T stays in the blocks' shared memory where the cluster holds it
//   (TS), else in the output buffer by slot. C blocks multiply the SMs
//   reading a sample's T.
// * Pivot-first panels. Only rows at or below the rank give a pivot, and a
//   panel has one iff such a row holds a panel bit (the first such column
//   finds it). So the blocks first compute the words of their slots at or
//   below the rank; a cluster barrier and a flag a block tell every block
//   whether any is nonzero, and (the b-exit) whether any of those slots
//   still carries a syndrome bit. If none holds a word, the panel changes
//   nothing: next panel, one cluster barrier. Rows above the rank are read
//   only in panels with a pivot.
// * The leader (block 0) gathers the words and b of the rows at or below
//   the rank through distributed shared memory (pslot, the slot of each
//   logical row, is spread over the blocks like the slots), compacts the
//   list (those holding a bit and the 32 from the rank) with a block-wide
//   scan, and one warp eliminates the panel on it (gf2_transform_panel.cuh's
//   eliminate_panel, without the rows above the rank, which never take part
//   in a pivot's choice and never swap). At each pivot k it records the
//   pivot row's panel word PW_k, its mask over U PM_k and its b, and writes
//   the list rows' masks, b and logical rows back to their slots' blocks and
//   their slots to pslot. Meanwhile every other warp of the cluster computes
//   its block's rows above the rank's panel words (a warp a row). The only
//   per-row arrays a block holds beyond its own R slots are the leader's
//   list (its words, masks, slots and logical rows), so that a cluster of 16
//   takes 9,312 rows in shared memory alone.
// * Past that (SP, "spilled"), the terms that do not shrink with C leave
//   shared memory: the panel's (word, column) pairs and U go to a global
//   workspace of each block, the leader's list to one of each sample (both
//   stay in L1 and L2), and the panel's columns are read from Hc where
//   they are needed instead of staged. A block then holds only its own
//   slots' state (17 bytes a slot, 32-bit slots and places), so that a
//   cluster of 16 takes 217,808 rows; T is in global memory.
// * Each row above the rank then replays the panel's pivots in column order
//   (a thread a row): if it holds pivot k's column bit it XORs in PW_k,
//   PM_k with bit k, and b_k. By linearity that is the mask and b the
//   sequential walk gives it (tests/test_torch_k4g_cluster.py holds the
//   claim).
// * Each block stages U (the pivots' panel-start rows) in its own shared
//   memory (SP: its workspace); a cluster barrier; then each row whose mask
//   is set takes its U rows (a warp a row, a lane a word). Three cluster
//   barriers a panel with a pivot, one without.
//
// At the end each block writes its slots' b, and its rows of T to their
// logical rows: from shared memory directly; from global memory in place,
// the same few words of every slot at a time in every block, staged in the
// shared memory (SP: the workspace) the walk no longer needs, a cluster
// barrier between staging and writing. The exits
// are K4's (at every 32nd column: rank(H) reached, or with the b-exit no
// syndrome bit at or below the rank), so T, b, rank and piv_col equal the
// plain version's (ops/osd_transform_cuda.py::eliminate_transform_plain).
//
// Built with K4G_PROBE defined (scripts/probe_k4g.py's copy only), thread 0
// of every block adds clock64() cycles per step and counts into a buffer
// set by gf2_transform_elim_global_set_probe.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gf2_transform_panel.cuh"

namespace cg = cooperative_groups;

#ifndef THREADS
#define THREADS 1024  // a probe's build may pick another block size
#endif
#define MAX_ROWS 65536  // the shared layout's slots and list rows are 16-bit
#define MAX_CLUSTER 16

// The slots' and places' type, and the bit of a list row's slot word that
// carries its b (the slot in the bits below it): 16-bit with b in bit 16 in
// the shared layout, 32-bit with b in bit 31 in the spilled one.
template <bool SP> struct Layout {
    using Ix = uint16_t;
    static constexpr int BB = 16;
};
template <> struct Layout<true> {
    using Ix = uint32_t;
    static constexpr int BB = 31;
};

#ifdef K4G_PROBE
#define NPROBE 24
__device__ unsigned long long* k4g_probe_buf = nullptr;
#define PROBE_MARK(idx)                                   \
    do {                                                  \
        if (tid == 0) {                                   \
            const long long now_ = clock64();             \
            pacc[idx] += (unsigned long long)(now_ - t_); \
            t_ = now_;                                    \
        }                                                 \
    } while (0)
#define PROBE_ADD(idx, v) \
    do {                  \
        if (tid == 0) pacc[idx] += (unsigned long long)(v); \
    } while (0)
#else
#define PROBE_MARK(idx) do {} while (0)
#define PROBE_ADD(idx, v) do {} while (0)
#endif

// The panel bits of one row of T: a warp, a lane a listed (word, column)
// pair (pwj: the word above the low 5 bits, the panel column in them; pm:
// the column's word there), the lanes' bits XORed together (every lane gets
// the word). Every lane does the same work whatever the columns' weights.
template <typename Ix>
__device__ __forceinline__ uint32_t panel_word(
    const uint32_t* row, const Ix* pwj, const uint32_t* pm, int np, int lane)
{
    uint32_t wv = 0;
#pragma unroll 4
    for (int p = lane; p < np; p += 32) {
        const uint32_t wj = pwj[p];
        wv ^= (uint32_t)(__popc(row[wj >> 5] & pm[p]) & 1) << (wj & 31u);
    }
    return __reduce_xor_sync(FULL, wv);
}

// The panel words of a block's own rows above the rank into Wsl: warps
// first, first + step, ... a row each.
template <typename Ix>
__device__ __forceinline__ void above_words(
    const uint32_t* Town, int nr, int rank, const Ix* lrow, uint32_t* Wsl,
    const Ix* pwj, const uint32_t* pm, int np, int mw, int first, int step, int lane)
{
    for (int r = first; r < nr; r += step) {
        if (lrow[r] >= rank) continue;
        const uint32_t wv = panel_word(Town + (size_t)r * mw, pwj, pm, np, lane);
        if (lane == 0) Wsl[r] = wv;
    }
}

// One warp of the leader eliminates the panel on the rows at or below the
// rank: eliminate_panel (gf2_transform_panel.cuh) on a list without the
// rows above the rank (its prank is 0; the block compacted the L list rows'
// words into W and their slots, b in bit 16, into cX, in logical order),
// which also records each pivot's column, panel word, mask over U, slot and
// b, and writes piv_col to global memory. Leaves each list position's slot
// and b in W[q] and its mask in cX[q]. BB: the bit of the slot word that
// carries b.
template <int BB>
__device__ __forceinline__ void eliminate_below(
    uint32_t* W, uint32_t* cW, uint32_t* cX,
    int* piv_g, int* s_pcol, uint32_t* s_pw, uint32_t* s_pm, int* s_src, uint32_t* s_pb,
    int* s_rank, int* s_npiv, int L, int ncols, int col0, int rank0, int lane)
{
    const int LG = (L + 31) >> 5;
    uint32_t* cM = W;  // once the list's words are in cW
    for (int g = 0; g < LG; ++g) {
        const int q = 32 * g + lane;
        const uint32_t x = q < L ? W[q] : 0u, sb = q < L ? cX[q] : 0u;
        cW[32 * g + lane] = transpose32(x, lane);
        cX[32 * g + lane] = transpose32(sb, lane);
    }
    __syncwarp();
    for (int g = 0; g < LG; ++g) cM[32 * g + lane] = 0u;
    __syncwarp();

    uint32_t* myW = cW + lane;  // word g of my columns at my?[32 g]
    uint32_t* myM = cM + lane;
    uint32_t* myX = cX + lane;
    int k = 0, mypiv = -1;
    uint32_t pb = 0;
    for (int j = 0; j < ncols; ++j) {
        const int pr = k;  // the rank row's position
        // the columns from j on with a bit at or after the rank row, each
        // lane its own; the columns before the first of them hold no pivot
        // and nothing changes until it, so the walk goes there at once
        int first = L;
        if (lane >= j && lane < ncols) {
            for (int g = pr >> 5; g < LG; ++g) {
                uint32_t x = myW[32 * g];
                if (g == pr >> 5) x &= FULL << (pr & 31);
                if (x) {
                    first = 32 * g + __ffs(x) - 1;
                    break;
                }
            }
        }
        const uint32_t cand = __ballot_sync(FULL, first < L);
        if (!cand) break;  // no pivot in the rest of the panel
        j = __ffs(cand) - 1;
        const int q = __shfl_sync(FULL, first, j);
        const int gq = q >> 5, gr = pr >> 5;
        const uint32_t eq = 1u << (q & 31), er = 1u << (pr & 31);
        // the pivot row's bits in my vectors, then the swap of q and pr
        const uint32_t wq = myW[32 * gq], wr = myW[32 * gr];
        const uint32_t mq = myM[32 * gq], mr = myM[32 * gr];
        const uint32_t xq = myX[32 * gq], xr = myX[32 * gr];
        const bool hw = wq & eq, hm = mq & eq, hx = xq & eq;
        if (q != pr) {
            if (hw != (bool)(wr & er)) {
                myW[32 * gq] = wq ^ eq;
                myW[32 * gr] = (gq == gr ? wq ^ eq : wr) ^ er;
            }
            if (hm != (bool)(mr & er)) {
                myM[32 * gq] = mq ^ eq;
                myM[32 * gr] = (gq == gr ? mq ^ eq : mr) ^ er;
            }
            if (hx != (bool)(xr & er)) {
                myX[32 * gq] = xq ^ eq;
                myX[32 * gr] = (gq == gr ? xq ^ eq : xr) ^ er;
            }
        }
        // the pivot row as the rows above the rank replay it
        const uint32_t pw = __ballot_sync(FULL, hw), pm = __ballot_sync(FULL, hm);
        const uint32_t sx = __ballot_sync(FULL, hx);  // the pivot's slot, and its b in bit BB
        if (lane == 0) {
            s_pcol[k] = j;
            s_pw[k] = pw;
            s_pm[k] = pm;
            s_src[k] = (int)(sx & ((1u << BB) - 1u));
        }
        pb |= ((sx >> BB) & 1u) << k;
        if (lane == k) mypiv = col0 + j;
        __syncwarp();  // column j after the swap
        // every other row holding bit j takes the pivot row: its W bits,
        // its mask over U with pivot k, its b
        const bool doW = hw && lane != j, doM = hm || lane == k, doX = lane == BB && hx;
        for (int g = 0; g < LG; g += 4) {
            uint32_t s[4], a[4], b[4], c[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const bool in = g + u < LG;
                s[u] = in ? cW[32 * (g + u) + j] : 0u;
                if (g + u == gr) s[u] &= ~er;
                a[u] = in && doW ? myW[32 * (g + u)] : 0u;
                b[u] = in && doM ? myM[32 * (g + u)] : 0u;
                c[u] = in && doX ? myX[32 * (g + u)] : 0u;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                if (g + u >= LG) break;
                if (doW) myW[32 * (g + u)] = a[u] ^ s[u];
                if (doM) myM[32 * (g + u)] = b[u] ^ s[u];
                if (doX) myX[32 * (g + u)] = c[u] ^ s[u];
            }
        }
        __syncwarp();
        ++k;
    }

    // each list position's slot and b (cX transposed back) to W, its mask
    // (cM transposed back) to cX
    for (int g = 0; g < LG; ++g) {
        const uint32_t y = transpose32(cX[32 * g + lane], lane);
        const uint32_t mk = transpose32(cM[32 * g + lane], lane);
        const int q = 32 * g + lane;
        if (q < L) {
            W[q] = y;
            cX[q] = mk;
        }
    }
    if (lane < k) piv_g[rank0 + lane] = mypiv;
    if (lane == 0) {
        *s_pb = pb;
        *s_rank = rank0 + k;
        *s_npiv = k;
    }
}

// Dynamic shared memory of one block (the Python mirror is
// ops/osd_transform_cuda.py::global_smem_bytes): the staged panel columns at
// an odd stride, the (word, column) pairs' words, U (the leader's cW while
// it eliminates); per own slot (R) the panel word and the mask; the
// leader's list (m_pad): the gathered words (then cM), cX; with TS the
// block's R rows of T; then 16-bit: the pairs' places, per own slot its
// logical row and per own logical row its slot, the list's logical rows;
// per own slot b. Spilled (sp): per own slot the panel word, the mask, its
// logical row and the slot of each own logical row (32-bit), and b.
static size_t k4g_smem_bytes(int m, int mw, int C, int ts, int sp)
{
    const size_t m_pad = (size_t)((m + 31) / 32) * 32, R = (size_t)((m + C - 1) / C);
    if (sp) return 16 * R + R + (ts ? 4 * R * mw : 0);
    const size_t words = PANEL * (size_t)(mw | 1) + 2 * PANEL * (size_t)mw + 2 * R
                         + 2 * m_pad + (ts ? R * mw : 0);
    return 4 * words + 2 * (PANEL * (size_t)mw + 2 * R + m_pad) + R;
}

// The spilled layout's global workspace, in words: the pairs' words, their
// places and U of each block (3 m_pad, m_pad = PANEL * mw), then the
// leader's list of each sample (its words, slots and b, logical rows).
static size_t k4g_workspace_words(int B, int m, int C)
{
    const size_t m_pad = (size_t)((m + 31) / 32) * 32;
    return 3 * m_pad * ((size_t)B * C + B);
}

template <bool TS, bool SP>
__global__ void __launch_bounds__(THREADS, 1) gf2_transform_elim_global_kernel(
    const int* __restrict__ order, const uint32_t* __restrict__ Hc,
    uint32_t* T_out, int* __restrict__ b_io,
    int* __restrict__ rank_out, int* __restrict__ piv_out, uint32_t* ws,
    int m, int mw, int n, int h_rank, int b_exit, int C)
{
    using Ix = typename Layout<SP>::Ix;
    constexpr int BB = Layout<SP>::BB;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    // the leader's panel record, copied by every block once a panel pivots
    __shared__ int s_pcol[PANEL], s_src[PANEL];
    __shared__ uint32_t s_pw[PANEL], s_pm[PANEL], s_pb;
    __shared__ int s_rank, s_npiv, s_np[2], s_any[2], s_wcnt[32];
    __shared__ int s_col[SP ? PANEL : 1];  // SP: the panel's columns of H

    cg::cluster_group cluster = cg::this_cluster();
    const int crank = (int)cluster.block_rank();
    const bool leader = crank == 0;
    const int G = (m + 31) >> 5, m_pad = G * 32;
    const int stride = mw | 1;
    const int R = (m + C - 1) / C, r0 = crank * R, nr = max(0, min(R, m - r0));
    const int s = blockIdx.x / C, tid = threadIdx.x, nt = blockDim.x;
    uint32_t *hc, *pm, *U, *Wsl, *Msl, *Wl, *cX, *Tsm;
    Ix *pwj, *lrow, *pslot, *lab;
    uint8_t* bsl;
    if (SP) {
        uint32_t* own = ws + (size_t)blockIdx.x * 3 * m_pad;
        uint32_t* list = ws + ((size_t)gridDim.x + s) * 3 * m_pad;
        hc = nullptr;                                 // the columns are read from Hc
        pm = own;                                     // m_pad, the (word, column) pairs' words
        pwj = (Ix*)(pm + m_pad);                      // m_pad, the pairs' word, column
        U = (uint32_t*)pwj + m_pad;                   // m_pad, pivots' rows; leader: cW
        Wl = list;                                    // m_pad, leader: the list's words, then cM
        cX = Wl + m_pad;                              // m_pad, leader: the list's slots and b
        lab = (Ix*)(cX + m_pad);                      // m_pad, leader: the list's logical rows
        Wsl = (uint32_t*)smem_raw;                    // R, own slots' panel words
        Msl = Wsl + R;                                // R, own slots' masks over U
        lrow = (Ix*)(Msl + R);                        // R, logical row of each own slot
        pslot = lrow + R;                             // R, slot of each own logical row r0 + r
        Tsm = (uint32_t*)(pslot + R);                 // TS: R * mw, own rows of T
        bsl = (uint8_t*)(Tsm + (TS ? (size_t)R * mw : 0));  // R, own slots' b
    } else {
        hc = (uint32_t*)smem_raw;                     // PANEL * stride, staged columns
        pm = hc + PANEL * stride;                     // PANEL * mw, the (word, column) pairs' words
        U = pm + PANEL * mw;                          // PANEL * mw, pivots' rows; leader: cW
        Wsl = U + PANEL * mw;                         // R, own slots' panel words
        Msl = Wsl + R;                                // R, own slots' masks over U
        Wl = Msl + R;                                 // m_pad, leader: the list's words, then cM
        cX = Wl + m_pad;                              // m_pad, leader: the list's slots and b
        Tsm = cX + m_pad;                             // TS: R * mw, own rows of T
        pwj = (Ix*)(Tsm + (TS ? (size_t)R * mw : 0)); // PANEL * mw, pairs' word, column
        lrow = pwj + PANEL * mw;                      // R, logical row of each own slot
        pslot = lrow + R;                             // R, slot of each own logical row r0 + r
        lab = pslot + R;                              // m_pad, leader: the list's logical rows
        bsl = (uint8_t*)(lab + m_pad);                // R, own slots' b
    }

    const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5, stager = nwarps - 1;
    const int* ord = order + (size_t)s * n;
    int* b_s = b_io + (size_t)s * m;
    int* piv_g = piv_out + (size_t)s * m;
    uint32_t* Tg = T_out + (size_t)s * m * mw;        // row of slot r at Tg + r * mw
    uint32_t* Town = TS ? Tsm : Tg + (size_t)r0 * mw; // own slot r0 + r at Town + r * mw
#ifdef K4G_PROBE
    unsigned long long pacc[NPROBE];
    for (int k = 0; k < NPROBE; ++k) pacc[k] = 0;
    long long t_ = clock64();
    const long long t_start = t_;
    __shared__ unsigned int s_count;
    if (tid == 0) s_count = 0;
#endif

    for (int idx = tid; idx < nr * mw; idx += nt) {
        const int r = idx / mw, w = idx - r * mw, slot = r0 + r;
        Town[idx] = (slot >> 5) == w ? (1u << (slot & 31)) : 0u;
    }
    for (int r = tid; r < nr; r += nt) {
        lrow[r] = (Ix)(r0 + r);
        pslot[r] = (Ix)(r0 + r);
        bsl[r] = (uint8_t)b_s[r0 + r];
        piv_g[r0 + r] = -1;
    }
    if (tid < 2) s_np[tid] = 0;
    if (warp == stager && n > 0) {
        if (SP) {
            if (lane < n) s_col[lane] = __ldg(ord + lane);
        } else {
            stage_panel(hc, stride, ord, Hc, 0, n, mw, lane);
        }
    }
    cluster.sync();  // every block set up before any reads another

    // the exits at each panel's start: rank(H) reached here, the b-exit (no
    // syndrome bit at or below the rank) once step 2 has looked
    int rank = 0, par = 0;
    for (int col0 = 0; col0 < n && rank < h_rank; col0 += PANEL, par ^= 1) {
        const int ncols = min(PANEL, n - col0);
        cp_async_wait_all();
        __syncthreads();  // the panel's columns have landed
        if (tid == 0) s_np[par ^ 1] = 0;  // the next panel's count
        PROBE_ADD(0, 1);
        PROBE_MARK(1);

        // 1. the (word, column) pairs where a panel column is nonzero, a
        //    thread a word: its pairs at a place its atomicAdd reserves (the
        //    order of the pairs does not matter, their bits are XORed); SP:
        //    the columns' words read from Hc
        for (int w0 = 0; w0 < mw; w0 += nt) {
            const int w = w0 + tid;
            if (w >= mw) continue;
            uint32_t cols = 0;
            for (int j = 0; j < ncols; ++j) {
                const uint32_t x = SP ? __ldg(Hc + (size_t)s_col[j] * mw + w) : hc[j * stride + w];
                cols |= (uint32_t)(x != 0u) << j;
            }
            if (!cols) continue;
            int at = atomicAdd(&s_np[par], __popc(cols));
            for (; cols; cols &= cols - 1, ++at) {
                const int j = __ffs(cols) - 1;
                pm[at] = SP ? __ldg(Hc + (size_t)s_col[j] * mw + w) : hc[j * stride + w];
                pwj[at] = (Ix)((w << 5) | j);
            }
        }
        __syncthreads();
        if (warp == stager && col0 + PANEL < n) {
            if (SP) {
                if (col0 + PANEL + lane < n) s_col[lane] = __ldg(ord + col0 + PANEL + lane);
            } else {
                stage_panel(hc, stride, ord, Hc, col0 + PANEL, n, mw, lane);
            }
        }
        const int np = s_np[par];
        PROBE_MARK(2);

        // 2. the panel words of own slots at or below the rank, and whether
        //    any of them carries a syndrome bit
        int any = 0, unres = 0;
        for (int r = warp; r < nr; r += nwarps) {
            if (lrow[r] < rank) continue;
            const uint32_t wv = panel_word(Town + (size_t)r * mw, pwj, pm, np, lane);
            if (lane == 0) {
                Wsl[r] = wv;
                Msl[r] = 0u;
            }
            any |= wv != 0u;
            unres |= bsl[r];
#ifdef K4G_PROBE
            if (lane == 0) atomicAdd(&s_count, 1u);
#endif
        }
        any = __syncthreads_or(any);
        unres = __syncthreads_or(unres);
        if (tid == 0) s_any[par] = any | (unres << 1);
#ifdef K4G_PROBE
        if (tid == 0) {
            pacc[14] += s_count;
            s_count = 0;
        }
#endif
        PROBE_MARK(3);
        cluster.sync();  // barrier 1: the words and the flags
        int flags = 0;
        if (tid < C) flags = *cluster.map_shared_rank(&s_any[par], tid);
        const int pivots = __syncthreads_or(flags & 1);
        const int unresolved = __syncthreads_or(flags & 2);
        PROBE_MARK(4);
        if (b_exit && !unresolved) break;  // the b-exit, before the panel changes anything
        if (!pivots) continue;  // no row at or below the rank holds a panel bit
        PROBE_ADD(5, 1);

        // 3. the leader: the words, slots and b of the logical rows at or
        //    below the rank gathered and the list (those holding a bit and
        //    the 32 from the rank) compacted in logical order, a block-wide
        //    scan a chunk of rows; the panel's pivots on the list (warp 0);
        //    the list rows' masks, b and logical rows back to their slots'
        //    blocks, their slots to pslot. Meanwhile every other warp of the
        //    cluster computes the panel words of its block's rows above the
        //    rank.
        if (leader) {
            int L = 0;
            for (int base = rank; base < m; base += nt) {
                const int i = base + tid;
                uint32_t w = 0, x = 0;
                if (i < m) {
                    const int ci = i / R;
                    const int sl = cluster.map_shared_rank(pslot, ci)[i - ci * R];
                    const int c = sl / R, loc = sl - c * R;
                    w = cluster.map_shared_rank(Wsl, c)[loc];
                    x = (uint32_t)sl | ((uint32_t)cluster.map_shared_rank(bsl, c)[loc] << BB);
                }
                const bool in = i < m && (w != 0u || i < rank + PANEL);
                const uint32_t bal = __ballot_sync(FULL, in);
                if (lane == 0) s_wcnt[warp] = __popc(bal);
                __syncthreads();
                int off = L, tot = 0;
                for (int v = 0; v < nwarps; ++v) {
                    const int cnt = s_wcnt[v];
                    off += v < warp ? cnt : 0;
                    tot += cnt;
                }
                if (in) {
                    const int q = off + __popc(bal & ((1u << lane) - 1u));
                    Wl[q] = w;
                    cX[q] = x;
                    lab[q] = (Ix)i;
                }
                L += tot;
                __syncthreads();  // s_wcnt read before the next chunk's counts
            }
            PROBE_MARK(6);
            if (warp == 0)
                eliminate_below<BB>(Wl, U, cX, piv_g, s_pcol, s_pw, s_pm, s_src, &s_pb, &s_rank,
                                &s_npiv, L, ncols, col0, rank, lane);
            else
                above_words(Town, nr, rank, lrow, Wsl, pwj, pm, np, mw, warp - 1, nwarps - 1,
                            lane);
            __syncthreads();
            PROBE_MARK(7);
            for (int q = tid; q < L; q += nt) {
                const int i = lab[q], ci = i / R;
                const uint32_t y = Wl[q];
                const int sl = (int)(y & ((1u << BB) - 1u)), c = sl / R, loc = sl - c * R;
                cluster.map_shared_rank(Msl, c)[loc] = cX[q];
                cluster.map_shared_rank(bsl, c)[loc] = (uint8_t)((y >> BB) & 1u);
                cluster.map_shared_rank(lrow, c)[loc] = (Ix)i;
                cluster.map_shared_rank(pslot, ci)[i - ci * R] = (Ix)sl;
            }
            PROBE_ADD(12, L);
            PROBE_ADD(13, m - rank);
            PROBE_MARK(8);
        } else {
            above_words(Town, nr, rank, lrow, Wsl, pwj, pm, np, mw, warp, nwarps, lane);
        }
        cluster.sync();  // barrier 2: the panel's record and the masks written
        if (!leader && tid < PANEL + 1) {
            const int* src_pcol = cluster.map_shared_rank(s_pcol, 0);
            const int* src_src = cluster.map_shared_rank(s_src, 0);
            const uint32_t* src_pw = cluster.map_shared_rank(s_pw, 0);
            const uint32_t* src_pm = cluster.map_shared_rank(s_pm, 0);
            if (tid < PANEL) {
                s_pcol[tid] = src_pcol[tid];
                s_src[tid] = src_src[tid];
                s_pw[tid] = src_pw[tid];
                s_pm[tid] = src_pm[tid];
            } else {
                s_pb = *cluster.map_shared_rank(&s_pb, 0);
                s_rank = *cluster.map_shared_rank(&s_rank, 0);
                s_npiv = *cluster.map_shared_rank(&s_npiv, 0);
            }
        }
        __syncthreads();
        const int npiv = s_npiv;
        PROBE_MARK(9);

        // 4. own rows above the rank replay the panel's pivots in column
        //    order (mask and b), a thread a row; U staged
        for (int r = tid; r < nr; r += nt) {
            if (lrow[r] >= rank) continue;
            uint32_t wv = Wsl[r], mk = 0, bit = bsl[r];
#ifdef K4G_PROBE
            if (wv) atomicAdd(&s_count, 1u);
#endif
            for (int k = 0; wv && k < npiv; ++k) {
                if ((wv >> s_pcol[k]) & 1u) {
                    wv ^= s_pw[k];
                    mk ^= s_pm[k] ^ (1u << k);
                    bit ^= (s_pb >> k) & 1u;
                }
            }
            Msl[r] = mk;
            bsl[r] = (uint8_t)bit;
        }
        for (int idx = tid; idx < npiv * mw; idx += nt) {
            const int k = idx / mw, w = idx - k * mw, sl = s_src[k];
            if (TS) {
                const int c = sl / R;
                U[idx] = cluster.map_shared_rank(Tsm, c)[(size_t)(sl - c * R) * mw + w];
            } else {
                U[idx] = __ldcg(Tg + (size_t)sl * mw + w);
            }
        }
        PROBE_MARK(10);
        cluster.sync();  // barrier 3: U staged in every block before any row changes
        PROBE_MARK(11);
#ifdef K4G_PROBE
        if (tid == 0) {
            pacc[15] += s_count;
            s_count = 0;
        }
#endif

        // 5. every own row whose mask is set takes its U rows: a warp a row,
        //    a lane a word
        for (int r = warp; r < nr; r += nwarps) {
            const uint32_t mk = Msl[r];
            if (!mk) continue;
            uint32_t* row = Town + (size_t)r * mw;
            for (int w = lane; w < mw; w += 32) {
                uint32_t x = row[w];
                for (uint32_t bits = mk; bits; bits &= bits - 1) x ^= U[(__ffs(bits) - 1) * mw + w];
                row[w] = x;
            }
#ifdef K4G_PROBE
            if (lane == 0) atomicAdd(&s_count, 1u);
#endif
        }
        rank = s_rank;
        __syncthreads();  // own rows written before the next panel reads them
#ifdef K4G_PROBE
        if (tid == 0) {
            pacc[16] += s_count;
            s_count = 0;
        }
#endif
        PROBE_MARK(17);
    }
    cp_async_wait_all();  // a staged panel the exit left unread
    cluster.sync();  // no block reads another's shared memory past here
    PROBE_MARK(18);

    if (leader && tid == 0) rank_out[s] = rank;
    for (int r = tid; r < nr; r += nt) b_s[lrow[r]] = bsl[r];
    // T into logical order: each own slot's row to the row it holds
    if (TS) {
        for (int r = warp; r < nr; r += nwarps) {
            uint32_t* dst = Tg + (size_t)lrow[r] * mw;
            const uint32_t* src = Tsm + (size_t)r * mw;
            for (int w = lane; w < mw; w += 32) dst[w] = src[w];
        }
    } else {
        // in place: cw words of every own slot staged in hc .. cX (SP: the
        // block's workspace; no longer read), a cluster barrier, then written
        // to the rows they hold. cw follows R, not nr: every block of the
        // cluster takes the same words in the same rounds (a short last
        // block with a wider cw would meet the others' barriers a round
        // early and write words they have not staged yet)
        uint32_t* stage = SP ? pm : hc;
        const int room = SP ? 3 * m_pad : (int)(Tsm - hc);
        const int cw = max(1, min(mw, room / R));
        for (int w0 = 0; w0 < mw; w0 += cw) {
            const int c = min(cw, mw - w0);
            for (int idx = tid; idx < nr * c; idx += nt) {
                const int r = idx / c, j = idx - r * c;
                stage[idx] = __ldcg(Town + (size_t)r * mw + w0 + j);
            }
            cluster.sync();
            for (int idx = tid; idx < nr * c; idx += nt) {
                const int r = idx / c, j = idx - r * c;
                Tg[(size_t)lrow[r] * mw + w0 + j] = stage[idx];
            }
            cluster.sync();
        }
    }
    PROBE_MARK(19);
#ifdef K4G_PROBE
    if (tid == 0 && k4g_probe_buf) {
        pacc[20] = (unsigned long long)(clock64() - t_start);
        pacc[21] = (unsigned long long)nr;
        pacc[22] = (unsigned long long)rank;
        pacc[23] = (unsigned long long)C;
        unsigned long long* out = k4g_probe_buf + (size_t)blockIdx.x * NPROBE;
        for (int k = 0; k < NPROBE; ++k) out[k] = pacc[k];
    }
#endif
}

typedef void (*k4g_kernel_t)(const int*, const uint32_t*, uint32_t*, int*, int*, int*,
                             uint32_t*, int, int, int, int, int, int);

// The kernel's instance for T in shared memory (ts) or global memory, the
// shared or the spilled (sp) layout; null for T in shared memory spilled.
static k4g_kernel_t k4g_kernel(int ts, int sp)
{
    if (sp) return ts ? nullptr : &gf2_transform_elim_global_kernel<false, true>;
    return ts ? &gf2_transform_elim_global_kernel<true, false>
              : &gf2_transform_elim_global_kernel<false, false>;
}

// The instance's shared memory opted in (and clusters past 8 allowed) and a
// launch configuration of B clusters of C blocks.
static cudaError_t k4g_config(k4g_kernel_t kernel, size_t smem, int B, int C,
                              cudaLaunchConfig_t* config, cudaLaunchAttribute* attr)
{
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && C > 8)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    *config = {};
    config->gridDim = dim3(B * C);
    config->blockDim = dim3(THREADS);
    config->dynamicSmemBytes = smem;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = C;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    config->attrs = attr;
    config->numAttrs = 1;
    return err;
}

extern "C" int gf2_transform_elim_global_smem_bytes(int m, int mw, int C, int ts, int sp)
{
    return (int)k4g_smem_bytes(m, mw, C, ts, sp);
}

extern "C" long long gf2_transform_elim_global_workspace_words(int B, int m, int C, int sp)
{
    return sp ? (long long)k4g_workspace_words(B, m, C) : 0;
}

// The static shared memory of the instance (ts, sp), which
// ops/osd_transform_cuda.py reserves as _GLOBAL_STATIC_SMEM (a negative
// cudaError_t if the instance does not exist or the query fails).
extern "C" int gf2_transform_elim_global_static_smem(int ts, int sp)
{
    k4g_kernel_t kernel = k4g_kernel(ts, sp);
    if (!kernel) return -(int)cudaErrorInvalidValue;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)kernel);
    return err == cudaSuccess ? (int)attr.sharedSizeBytes : -(int)err;
}

#ifdef K4G_PROBE
extern "C" int gf2_transform_elim_global_set_probe(void* buf)
{
    unsigned long long* p = (unsigned long long*)buf;
    return (int)cudaMemcpyToSymbol(k4g_probe_buf, &p, sizeof(p));
}
#endif

// The clusters of width C that the card runs at once for a system of m
// rows in the layout (ts, sp) (0 if none: the launch would fail; a negative
// cudaError_t if the query fails). ops/osd_transform_cuda.py widens a
// cluster to 16 only where every sample's cluster fits at once.
extern "C" int gf2_transform_elim_global_max_clusters(int m, int mw, int C, int ts, int sp)
{
    k4g_kernel_t kernel = k4g_kernel(ts, sp);
    if (!kernel || C < 1 || C > MAX_CLUSTER) return -(int)cudaErrorInvalidValue;
    cudaLaunchConfig_t config;
    cudaLaunchAttribute attr[1];
    cudaError_t err = k4g_config(kernel, k4g_smem_bytes(m, mw, C, ts, sp), 1, C, &config, attr);
    if (err != cudaSuccess) return -(int)err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &config);
    return err == cudaSuccess ? clusters : -(int)err;
}

extern "C" int gf2_transform_elim_global_launch(
    const void* order, const void* Hc, void* T_out, void* b_io,
    void* rank_out, void* piv_out, void* ws, long long ws_words, int B, int m, int mw, int n,
    int h_rank, int b_exit, int C, int ts, int sp, void* stream_)
{
    const int G = (m + 31) / 32;
    k4g_kernel_t kernel = k4g_kernel(ts, sp);
    if (m < 1 || (!sp && G * 32 > MAX_ROWS) || mw != G || C < 1 || C > MAX_CLUSTER || !kernel)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaSuccess;
    if (sp && (ws == nullptr || ws_words < (long long)k4g_workspace_words(B, m, C)))
        return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t config;
    cudaLaunchAttribute attr[1];
    cudaError_t err = k4g_config(kernel, k4g_smem_bytes(m, mw, C, ts, sp), B, C, &config, attr);
    if (err != cudaSuccess) return (int)err;
    config.stream = (cudaStream_t)stream_;
    err = cudaLaunchKernelEx(
        &config, kernel,
        (const int*)order, (const uint32_t*)Hc, (uint32_t*)T_out, (int*)b_io,
        (int*)rank_out, (int*)piv_out, (uint32_t*)ws, m, mw, n, h_rank, b_exit, C);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
