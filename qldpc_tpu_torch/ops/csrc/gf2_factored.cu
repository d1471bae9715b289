// Factored (T-free) GF(2) elimination for wide systems (K5a-d).
//
// Replaces the four Pallas kernels of qldpc_tpu/ops/osd_factored.py:
//   K5a factored_y_kernel       <- _y_kernel       (Y = P . H_blk)
//   K5b factored_w_kernel       <- _w_kernel       (W = H_blk ^ C . Y)
//   K5c factored_elim_kernel    <- _elim_kernel    (K-column panel RREF on [W | b])
//   K5d factored_resolve_kernel <- _resolve_kernel (P_new = e_p ^ G.P ^ D.P_new)
// and computes what the plain versions in ops/osd_factored_cuda.py compute,
// bit for bit. All products are over GF(2) on bit-packed uint32 words.
//
// What bounds it on the card: integer operations. At the [[144,12,12]] DEM
// (m_pad = 1,728 rows, mw = 54 words, K = 128 columns a block, up to 2,304
// scheduled columns) each block of each running sample costs three GF(2)
// products of scur x m_pad x K bits (scur = columns scheduled before the
// block), about 1.2e9 bit operations at the last blocks; P and C, the
// factored state, are 0.5 GB each at B = 1,024 and are streamed once per
// product. The design keeps each product's reused operand in shared memory
// and streams the other from device memory coalesced:
//   K5a  one block per sample and run of row tiles. H is an LDPC matrix (a
//        [[144]] DEM column sets ~7 of its 1,728 bits), so the block first
//        lists each of its 128 columns' nonzero words (a warp reads a column
//        coalesced and compacts it by ballot: word index and mask), once for
//        all its tiles; then tiles of up to 128 P rows come in by cp.async,
//        double-buffered, and thread (q, s) forms word q of Y[s] as 32
//        parities, each an XOR of P[s][w] & mask over its column's list (one
//        term per nonzero word, not one per word of the row); a warp shares
//        q, so the lists are broadcast and the walk does not diverge;
//   K5b  a block of 512 threads a sample and tile of rows: the tile is the
//        whole sample (up to 2,048 rows, four a thread) while the samples
//        give two blocks an SM, and shrinks to 32 rows as they thin out, so
//        Y (up to 37 KB) is staged once a sample by cp.async where it is
//        read most. The H bits come from the block columns' words over the
//        tile, each read once (a warp eight columns at a time, a lane a
//        word), set bit by bit into the tile's W rows in shared memory. C
//        is word-major with the rows minor: the tile's coefficient words
//        come in by cp.async in chunks of up to 32 KB (the whole tile at the
//        [[144]] DEM; double-buffered beyond), the first with Y while H is
//        listed, and each thread XORs in the Y rows of its words' set bits
//        (C is under 0.3% set: 1.6 bits a nonzero word). A small tile
//        splits each row's words into slices (16 at 32 rows), whose sums
//        meet by atomicXor in the tile's rows;
//   K5c  one warp runs a sample's 128 columns, several samples a block,
//        no barrier per column: W sits column-major in shared memory
//        (column j a mask over rows, mw words; 28 KB a sample at the
//        [[144]] DEM), lane l owns words l, l + 32, ... of every column and
//        of b and the pivoted flags (in registers). Per column the pivot is
//        the lowest set bit of col_j & ~piv (a ballot per 32 words, a
//        shuffle, __ffs), row p's bits in the block are bit p of every
//        column (a ballot per 32 columns), M = col_j ^ e_p is the rows it
//        eliminates, which is C's new column j and overwrites col_j, and
//        each later column holding bit p takes ^= M. W comes in and C goes
//        out through one 32 x 32 bit transpose per word group, a five-step
//        butterfly of __shfl_xor_sync (five shuffles against the 32 ballots
//        and selects of the other way); when the samples are few, a group
//        of four warps shares those transposes, with one named barrier
//        before the columns and one after;
//   K5d  one block per sample, no barrier per pivot column. With N the
//        strictly lower part of the block's D (the pivot rows' block
//        coefficients) and L = I ^ N, P_new = L^-1 (E ^ G.P), E the pivot
//        rows' unit rows. One warp forward-substitutes L^-1 in registers
//        (a row broadcast by __shfl_sync per pivot that some later pivot
//        row holds) while the other warps gather G. G is sparse (under 0.3%
//        of its bits at the [[144]] DEM), so the block stages only the P
//        rows that some row of G references, in tiles of 64 rows brought in
//        by cp.async, double-buffered; G's bits are renumbered to those
//        rows' ranks and each thread walks the set bits of its 8-64 output
//        rows (a warp shares its rows, so the walk does not diverge),
//        accumulating in registers; then X = E ^ G.P goes to shared memory
//        and each output row XORs the X rows of its L^-1 bits.
// The TPU kernels' VMEM budget models, 128-lane slabs and the XLA row
// gathers around them (Mosaic cannot gather) are not carried over: each
// kernel gathers its own columns and rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "warp_util.cuh"

#define K 128
#define KW 4
#define W_THREADS 512  // K5b: threads a block
#define W_CHUNK_WORDS 8192  // K5b: C words a staged chunk (32 KB)
#define W_H_COLS 8  // K5b: H's block columns a warp reads at a time
#define RESOLVE_THREADS 512
#define RESOLVE_WARPS (RESOLVE_THREADS / 32)
#define TILE_ROWS 64  // staged P rows a buffer; two buffers hold K rows
#define Y_TILE_MAX 128  // K5a: P rows a tile, four threads a row
#define ELIM_SAMPLES_MAX 8  // K5c: samples a block
#define ELIM_GROUP 4  // K5c: warps a sample
#define FULL 0xffffffffu
#define SMEM_MAX 232448

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes)
{
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    if (bytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
    else if (bytes == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" :: "r"(d), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src) : "memory");
}

// K5a: Y[a][s][q] bit kk = parity(P[lane][s] & Hc[ids[a][32 q + kk]]), s < scur.
// Block (a, y) takes row tiles [y * per, (y + 1) * per) of sample a; rows
// rows a tile, 4 * rows threads.
__global__ void factored_y_kernel(
    const uint32_t* __restrict__ P, const int* __restrict__ lanes,
    const int* __restrict__ ids, const uint32_t* __restrict__ Hc,
    uint32_t* __restrict__ Y, int s_max, int mw, int scur, int rows, int per)
{
    extern __shared__ __align__(16) uint32_t smem[];
    const int stride = mw | 1;  // odd: a thread per row, no bank conflicts
    uint2* pairs = reinterpret_cast<uint2*>(smem);  // K x mw: (word, bits) of each column's nonzero words
    int* cnt = reinterpret_cast<int*>(pairs + (size_t)K * mw);  // K: their number
    uint32_t* tiles = reinterpret_cast<uint32_t*>(cnt + K);     // 2 x rows x stride staged P rows
    const int a = blockIdx.x, tid = threadIdx.x;
    const int lid = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
    const int t0 = blockIdx.y * per;
    const int t1 = min((scur + rows - 1) / rows, t0 + per);
    const uint32_t* Pl = P + (size_t)lanes[a] * s_max * mw;

    auto stage = [&](int t) {
        uint32_t* dst = tiles + (size_t)((t - t0) & 1) * rows * stride;
        const uint32_t* src = Pl + (size_t)t * rows * mw;
        const int nr = min(rows, scur - t * rows);
        for (int i = tid; i < nr * mw; i += blockDim.x) {
            const int r = i / mw;
            cp_async(dst + r * stride + (i - r * mw), src + i, 4);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    stage(t0);

    // the supports: a warp reads a column's words coalesced, four columns'
    // loads in flight, and compacts the nonzero ones by ballot
    for (int k0 = warp; k0 < K; k0 += 4 * nwarps) {
        const uint32_t* col[4];
        int c[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int k = k0 + u * nwarps;
            col[u] = k < K ? Hc + (size_t)ids[(size_t)a * K + k] * mw : nullptr;
            c[u] = 0;
        }
        for (int w0 = 0; w0 < mw; w0 += 32) {
            const int w = w0 + lid;
            uint32_t v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) v[u] = col[u] && w < mw ? col[u][w] : 0u;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const uint32_t bal = __ballot_sync(FULL, v[u] != 0u);
                if (v[u])
                    pairs[(size_t)(k0 + u * nwarps) * mw + c[u] + __popc(bal & ((1u << lid) - 1u))] =
                        make_uint2((uint32_t)w, v[u]);
                c[u] += __popc(bal);
            }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (lid == 0 && col[u]) cnt[k0 + u * nwarps] = c[u];
    }

    const int q = tid / rows, r = tid - q * rows;  // rows is a multiple of 32: q is a warp's
    for (int t = t0; t < t1; ++t) {
        if (t + 1 < t1) {
            stage(t + 1);
            asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        __syncthreads();
        const int s = t * rows + r;
        if (s < scur) {
            const uint32_t* row = tiles + (size_t)((t - t0) & 1) * rows * stride + (size_t)r * stride;
            uint32_t word = 0u;
            for (int kk = 0; kk < 32; ++kk) {
                const int k = q * 32 + kk;
                const uint2* pk = pairs + (size_t)k * mw;
                uint32_t x = 0u;
#pragma unroll 4
                for (int i = 0; i < cnt[k]; ++i) {
                    const uint2 pr = pk[i];  // the same for the whole warp: a broadcast
                    x ^= row[pr.x] & pr.y;
                }
                word |= (uint32_t)(__popc(x) & 1) << kk;
            }
            Y[((size_t)a * scur + s) * KW + q] = word;
        }
        __syncthreads();  // the buffer is restaged two tiles on
    }
}

// K5b: W[a][r] = (H bits of row r in the block's columns) ^ XOR_{s < scur,
// C[lane][s / 32][r] bit s % 32} Y[a][s]. Block (a, y) takes rows [y *
// rows, (y + 1) * rows) of sample a. A thread takes R rows and one slice of
// C's words (slices = threads x R / rows); C's words come in chunks of
// cwords words of every row of the tile. Every term goes into the tile's
// rows in shared memory by atomicXor (H's bits are distinct, so XOR sets
// them as OR would), in any order.
template <int R>
__global__ void __launch_bounds__(W_THREADS) factored_w_kernel(
    const uint32_t* __restrict__ C, const int* __restrict__ lanes,
    const int* __restrict__ ids, const uint32_t* __restrict__ Hc,
    const uint32_t* __restrict__ Y, uint32_t* __restrict__ W,
    int cw, int m_pad, int mw, int scur, int rows, int cwords)
{
    extern __shared__ __align__(16) uint32_t smem[];
    const int nt = blockDim.x, tid = threadIdx.x, G = rows / R, S = nt / G;
    const int sw_n = scur >> 5, n_chunks = (sw_n + cwords - 1) / cwords;
    uint4* Ys = reinterpret_cast<uint4*>(smem);                   // scur
    uint32_t* Cs = smem + (size_t)scur * KW;                       // 1-2 x cwords x rows
    uint32_t* Ws = Cs + (size_t)(n_chunks > 1 ? 2 : 1) * cwords * rows;  // rows x KW
    int* ids_s = reinterpret_cast<int*>(Ws + (size_t)rows * KW);  // K
    const int a = blockIdx.x, r0 = blockIdx.y * rows;
    const int nr = min(rows, m_pad - r0);  // a multiple of 32
    const uint32_t* Cl = C + (size_t)lanes[a] * cw * m_pad + r0;  // word sw, row r: Cl[sw m_pad + r]

    // chunk ch of C: word u of tile row r at Cs[buffer][u rows + r], four rows
    // a copy: thread t copies rows 4 (t % (rows / 4)) of words t / (rows / 4),
    // + nt / (rows / 4), ... (rows and nt are powers of two, rows / 4 <= nt)
    const int lg4 = __ffs(rows) - 3, r4 = 4 * (tid & ((rows >> 2) - 1)), u0 = tid >> lg4;
    auto stage = [&](int ch) {
        uint32_t* dst = Cs + (size_t)(ch & 1) * cwords * rows;
        const int s0 = ch * cwords, nu = min(cwords, sw_n - s0);
        if (r4 < nr)
            for (int u = u0; u < nu; u += nt >> lg4)
                cp_async(dst + (size_t)u * rows + r4, Cl + (size_t)(s0 + u) * m_pad + r4, 16);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    // Y and C's first chunk in flight while H is listed
    const uint4* Ya = reinterpret_cast<const uint4*>(Y) + (size_t)a * scur;
    for (int i = tid; i < scur; i += nt) cp_async(Ys + i, Ya + i, 16);
    if (n_chunks) stage(0);
    else asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int i = tid; i < nr * KW; i += nt) Ws[i] = 0u;
    for (int k = tid; k < K; k += nt) ids_s[k] = ids[(size_t)a * K + k];
    __syncthreads();

    // the H bits: each (block column, word) of the tile read once, a warp
    // W_H_COLS columns at a time, a lane a word of each; bit k of W set in
    // the rows of each word's set bits (a [[144]] DEM column sets ~7 of its
    // 1,728 bits)
    const int w0 = r0 >> 5, nwr = nr >> 5, warp = tid >> 5, lid = tid & 31, nwarps = nt >> 5;
    for (int k0 = warp; k0 < K; k0 += W_H_COLS * nwarps)
        for (int w = lid; w < nwr; w += 32) {
            uint32_t h[W_H_COLS];
#pragma unroll
            for (int q = 0; q < W_H_COLS; ++q) {
                const int k = k0 + q * nwarps;
                h[q] = k < K ? Hc[(size_t)ids_s[k] * mw + w0 + w] : 0u;
            }
#pragma unroll
            for (int q = 0; q < W_H_COLS; ++q) {
                const int k = k0 + q * nwarps;
                uint32_t* dst = Ws + (size_t)(32 * w) * KW + (k >> 5);
                for (uint32_t x = h[q]; x; x &= x - 1u)
                    atomicXor(dst + (__ffs(x) - 1) * KW, 1u << (k & 31));
            }
        }

    // C . Y: C is under 0.3% set at the [[144]] DEM (a nonzero thread word
    // holds 1.6 bits), so each thread walks its words' set bits
    const int g = tid % G, slice = tid / G;
    uint4 acc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k] = make_uint4(0u, 0u, 0u, 0u);
    for (int ch = 0; ch < n_chunks; ++ch) {
        if (ch + 1 < n_chunks) {
            stage(ch + 1);
            asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        __syncthreads();
        const uint32_t* cs = Cs + (size_t)(ch & 1) * cwords * rows;
        const int s0 = ch * cwords, nu = min(cwords, sw_n - s0);
        for (int u = slice; u < nu; u += S) {
            const uint4* ys = Ys + (size_t)(s0 + u) * 32;
#pragma unroll
            for (int k = 0; k < R; ++k) {
                const int r = g + k * G;
                for (uint32_t x = r < nr ? cs[(size_t)u * rows + r] : 0u; x; x &= x - 1u) {
                    const uint4 v = ys[__ffs(x) - 1];
                    acc[k].x ^= v.x;
                    acc[k].y ^= v.y;
                    acc[k].z ^= v.z;
                    acc[k].w ^= v.w;
                }
            }
        }
        __syncthreads();  // the buffer is restaged two chunks on
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
        const int r = g + k * G;
        if (r < nr && (acc[k].x | acc[k].y | acc[k].z | acc[k].w)) {
            atomicXor(Ws + (size_t)r * KW, acc[k].x);
            atomicXor(Ws + (size_t)r * KW + 1, acc[k].y);
            atomicXor(Ws + (size_t)r * KW + 2, acc[k].z);
            atomicXor(Ws + (size_t)r * KW + 3, acc[k].w);
        }
    }
    __syncthreads();
    uint4* Wa = reinterpret_cast<uint4*>(W) + (size_t)a * m_pad + r0;
    for (int r = tid; r < nr; r += nt) Wa[r] = reinterpret_cast<const uint4*>(Ws)[r];
}

// K5c: the block's K columns eliminated in order on [W | b] with implicit
// pivots. b, piv (packed by row) and C's block columns are updated for the
// sample; prow gets each column's pivot row, m_pad where none. A group of
// `group` warps a sample: together they transpose W in and C out, and the
// group's first warp runs the columns, lane l owning words w = l + 32 t
// (t < NT, w < mw) of every column. Only the columns after j are updated at
// column j: W is not an output.
__device__ __forceinline__ void group_sync(int slot, int group)
{
    if (group > 1)  // named barrier slot + 1: the sample's warps alone
        asm volatile("bar.sync %0, %1;\n" :: "r"(slot + 1), "r"(32 * group) : "memory");
}

template <int NT>
__global__ void factored_elim_kernel(
    const uint32_t* __restrict__ W, uint32_t* __restrict__ b,
    uint32_t* __restrict__ piv, uint32_t* __restrict__ C,
    const int* __restrict__ lanes, const int* __restrict__ ids,
    int* __restrict__ prow_out, int A, int m_pad, int cw, int n, int blk, int group)
{
    extern __shared__ __align__(16) uint32_t smem[];
    const int mw = m_pad >> 5, stride = mw | 1;  // odd: a lane a column, no bank conflicts
    const int lid = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int slot = warp / group, gw = warp - slot * group;
    const int a = blockIdx.x * (blockDim.x >> 5) / group + slot;
    if (a >= A) return;  // the whole group: no barrier waits on it
    uint32_t* col = smem + (size_t)slot * K * stride;  // column j's rows at col + j * stride
    const size_t lane = (size_t)lanes[a];

    // W row-major in: word group g of rows, word q of columns, one transpose
    // each; eight groups' loads in flight a warp
    const uint4* Wa = reinterpret_cast<const uint4*>(W) + (size_t)a * m_pad;
    for (int g0 = 8 * gw; g0 < mw; g0 += 8 * group) {
        uint4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
            if (g0 + u < mw) v[u] = Wa[(g0 + u) * 32 + lid];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            if (g0 + u >= mw) break;
            const int g = g0 + u;
            col[(size_t)lid * stride + g] = transpose32(v[u].x, lid);
            col[(size_t)(32 + lid) * stride + g] = transpose32(v[u].y, lid);
            col[(size_t)(64 + lid) * stride + g] = transpose32(v[u].z, lid);
            col[(size_t)(96 + lid) * stride + g] = transpose32(v[u].w, lid);
        }
    }
    group_sync(slot, group);

    if (gw == 0) {
        uint32_t* b_l = b + lane * mw;
        uint32_t* piv_l = piv + lane * mw;
        uint32_t bw[NT], pw[NT];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            const int w = lid + 32 * t;
            bw[t] = w < mw ? b_l[w] : 0u;
            pw[t] = w < mw ? piv_l[w] : 0u;
        }
        uint32_t real[KW];  // bit i of word q: column 32 q + i is not a sentinel
        int prq[KW];
#pragma unroll
        for (int q = 0; q < KW; ++q) {
            real[q] = __ballot_sync(FULL, ids[(size_t)a * K + 32 * q + lid] < n);
            prq[q] = m_pad;
        }

#pragma unroll
        for (int q = 0; q < KW; ++q) {
            for (int i = 0; i < 32; ++i) {
                __syncwarp();  // the last column's writes before this one's reads of other lanes' words
                uint32_t* cj = col + (size_t)(32 * q + i) * stride;
                uint32_t c[NT];
#pragma unroll
                for (int t = 0; t < NT; ++t) c[t] = lid + 32 * t < mw ? cj[lid + 32 * t] : 0u;
                // the pivot: the lowest set bit of col_j & ~piv, a sentinel column none
                int p = m_pad;
                if ((real[q] >> i) & 1u) {
#pragma unroll
                    for (int t = 0; t < NT; ++t) {
                        const uint32_t cand = c[t] & ~pw[t];
                        const uint32_t bal = __ballot_sync(FULL, cand != 0u);
                        if (p == m_pad && bal) {
                            const int src = __ffs(bal) - 1;
                            p = ((32 * t + src) << 5) + __ffs(__shfl_sync(FULL, cand, src)) - 1;
                        }
                    }
                }
                if (lid == i) prq[q] = p;
                if (p == m_pad) {
#pragma unroll
                    for (int t = 0; t < NT; ++t)
                        if (lid + 32 * t < mw) cj[lid + 32 * t] = 0u;
                    continue;
                }
                const int pwi = p >> 5, pb = p & 31;
                // row p's bits in the block's columns: bit p of each column
                uint32_t rowp[KW];
#pragma unroll
                for (int qq = q; qq < KW; ++qq)
                    rowp[qq] = __ballot_sync(FULL, (col[(size_t)(32 * qq + lid) * stride + pwi] >> pb) & 1u);
                __syncwarp();  // those reads before any lane's writes
                uint32_t bsel = 0u;
#pragma unroll
                for (int t = 0; t < NT; ++t)
                    if (t == (pwi >> 5)) bsel = bw[t];
                const bool bp = (__shfl_sync(FULL, bsel, pwi & 31) >> pb) & 1u;
                uint32_t M[NT];  // the rows column j eliminates: C's new column j
#pragma unroll
                for (int t = 0; t < NT; ++t) {
                    const int w = lid + 32 * t;
                    const uint32_t e = w == pwi ? 1u << pb : 0u;
                    M[t] = c[t] ^ e;
                    if (bp) bw[t] ^= M[t];
                    pw[t] |= e;
                    if (w < mw) cj[w] = M[t];
                }
#pragma unroll
                for (int qq = q; qq < KW; ++qq) {
                    uint32_t later = qq == q ? rowp[qq] & ~((2u << i) - 1u) : rowp[qq];
                    while (later) {
                        // two columns at a time: both loads before either store
                        uint32_t* c1 = col + (size_t)(32 * qq + __ffs(later) - 1) * stride;
                        later &= later - 1u;
                        uint32_t* c2 = later ? col + (size_t)(32 * qq + __ffs(later) - 1) * stride : nullptr;
                        later &= later - 1u;
                        uint32_t v1[NT], v2[NT];
#pragma unroll
                        for (int t = 0; t < NT; ++t) {
                            const int w = lid + 32 * t;
                            v1[t] = w < mw ? c1[w] : 0u;
                            v2[t] = c2 && w < mw ? c2[w] : 0u;
                        }
#pragma unroll
                        for (int t = 0; t < NT; ++t) {
                            const int w = lid + 32 * t;
                            if (w < mw) c1[w] = v1[t] ^ M[t];
                            if (c2 && w < mw) c2[w] = v2[t] ^ M[t];
                        }
                    }
                }
            }
        }
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            const int w = lid + 32 * t;
            if (w < mw) {
                b_l[w] = bw[t];
                piv_l[w] = pw[t];
            }
        }
#pragma unroll
        for (int q = 0; q < KW; ++q) prow_out[(size_t)a * K + 32 * q + lid] = prq[q];
    }
    group_sync(slot, group);

    // C out: the masks M transposed back into row words, split as W came in
    uint32_t* Cb = C + (lane * cw + (size_t)blk * KW) * m_pad;
    for (int g0 = 2 * gw; g0 < mw; g0 += 2 * group)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int g = g0 + u;
            if (g >= mw) break;
#pragma unroll
            for (int q = 0; q < KW; ++q)
                Cb[(size_t)q * m_pad + g * 32 + lid] = transpose32(col[(size_t)(32 * q + lid) * stride + g], lid);
        }
}

// P rows [r0, r0 + nr) of the used-row list into a staging buffer, as one
// cp.async group per thread
__device__ __forceinline__ void stage_rows(
    uint32_t* dst, const uint32_t* Pl, const int* rows, int r0, int nr, int mw, int chunk)
{
    const int per_row = mw * 4 / chunk;
    for (int i = threadIdx.x; i < nr * per_row; i += blockDim.x) {
        const int r = i / per_row, c = i - r * per_row;
        cp_async(reinterpret_cast<char*>(dst + (size_t)r * mw) + c * chunk,
                 reinterpret_cast<const char*>(Pl + (size_t)rows[r0 + r] * mw) + c * chunk, chunk);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// K5d: P[lane][scur + j] = e_{prow[j]} ^ XOR_{s < scur, G[j][s]} P[lane][s]
// ^ XOR_{j2 < j, D[j][j2]} P_new[j2], G and D the C rows of the pivots,
// computed as L^-1 (E ^ G.P). RPG output rows a thread: a row group of
// RPG rows is spread over the warps that cover its mw words.
template <int RPG>
__global__ void __launch_bounds__(RESOLVE_THREADS) factored_resolve_kernel(
    uint32_t* __restrict__ P, const uint32_t* __restrict__ C,
    const int* __restrict__ lanes, const int* __restrict__ prow,
    int s_max, int mw, int cw, int m_pad, int blk, int chunk)
{
    constexpr int WPG = RPG * RESOLVE_WARPS / K;  // warps a row group
    extern __shared__ __align__(16) uint32_t smem[];
    __shared__ int pr[K];
    __shared__ uint32_t Li[K * KW];  // L^-1, row j in words 4 j .. 4 j + 3
    __shared__ int n_used;
    const int scur = blk * K, sw_n = scur >> 5;
    uint32_t* XT = smem;                        // 2 x TILE_ROWS x mw staged P rows, then K x mw X
    uint32_t* Gc = XT + (size_t)K * mw;         // sw_n x K: G's bits at the ranks of their rows
    uint32_t* U = Gc + (size_t)K * sw_n;        // sw_n: the rows some G row references
    int* pre = reinterpret_cast<int*>(U + sw_n);  // sw_n: set bits of U before word sw
    int* rows = pre + sw_n;                     // the referenced rows, ascending
    const int a = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    const int lid = tid & 31, warp = tid >> 5;
    const size_t lane = (size_t)lanes[a];
    const uint32_t* Cl = C + lane * cw * m_pad;
    uint32_t* Pl = P + lane * s_max * mw;

    for (int j = tid; j < K; j += nt) pr[j] = prow[(size_t)a * K + j];
    for (int i = tid; i < sw_n; i += nt) U[i] = 0u;
    for (int i = tid; i < K * sw_n; i += nt) Gc[i] = 0u;
    __syncthreads();

    if (warp == 0) {
        // L^-1 by forward substitution: lane l holds rows l + 32 kk; row
        // j2 is final once every pivot before it has been applied
        uint32_t d[4][KW], l[4][KW];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const int p = pr[lid + 32 * kk];
#pragma unroll
            for (int q = 0; q < KW; ++q) {
                const uint32_t v = p < m_pad ? Cl[(size_t)(blk * KW + q) * m_pad + p] : 0u;
                d[kk][q] = q < kk ? v : q == kk ? v & ((1u << lid) - 1u) : 0u;
                l[kk][q] = q == kk ? 1u << lid : 0u;
            }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            for (int i = 0; i < 32; ++i) {
                bool need = false;
#pragma unroll
                for (int kk = k; kk < 4; ++kk) need |= (d[kk][k] >> i) & 1u;
                if (!__any_sync(FULL, need)) continue;
                uint32_t row[KW];
#pragma unroll
                for (int q = 0; q < KW; ++q) row[q] = __shfl_sync(FULL, l[k][q], i);
#pragma unroll
                for (int kk = k; kk < 4; ++kk)
                    if ((d[kk][k] >> i) & 1u)
#pragma unroll
                        for (int q = 0; q < KW; ++q) l[kk][q] ^= row[q];
            }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int q = 0; q < KW; ++q) Li[(lid + 32 * kk) * KW + q] = l[kk][q];
    } else {
        for (int i = tid - 32; i < K * sw_n; i += nt - 32) {
            const int sw = i / K, p = pr[i - sw * K];
            const uint32_t g = p < m_pad ? Cl[(size_t)sw * m_pad + p] : 0u;
            if (g) atomicOr(&U[sw], g);
        }
    }
    __syncthreads();

    if (warp == 0) {
        int base = 0;
        for (int s0 = 0; s0 < sw_n; s0 += 32) {
            const int sw = s0 + lid;
            const int c = sw < sw_n ? __popc(U[sw]) : 0;
            int incl = c;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(FULL, incl, o);
                if (lid >= o) incl += y;
            }
            if (sw < sw_n) pre[sw] = base + incl - c;
            base += __shfl_sync(FULL, incl, 31);
        }
        if (lid == 0) n_used = base;
    }
    __syncthreads();

    for (int sw = tid; sw < sw_n; sw += nt) {
        uint32_t u = U[sw];
        for (int r = pre[sw]; u; u &= u - 1u) rows[r++] = sw * 32 + __ffs(u) - 1;
    }
    for (int i = tid; i < K * sw_n; i += nt) {
        // G again, from the L2: its set bits renumbered to their rows' ranks
        const int sw = i / K, j = i - sw * K, p = pr[j];
        uint32_t g = p < m_pad ? Cl[(size_t)sw * m_pad + p] : 0u;
        const uint32_t u = U[sw];
        for (; g; g &= g - 1u) {
            const int b = __ffs(g) - 1;
            const int pos = pre[sw] + __popc(u & ((1u << b) - 1u));
            atomicOr(&Gc[(pos >> 5) * K + j], 1u << (pos & 31));
        }
    }
    __syncthreads();

    // G.P over the staged rows; the block's warps split as (row group, words)
    const int nu = n_used, n_tiles = (nu + TILE_ROWS - 1) / TILE_ROWS;
    const int grp = warp / WPG, w = (warp - grp * WPG) * 32 + lid, j0 = grp * RPG;
    uint32_t acc[RPG];
#pragma unroll
    for (int jj = 0; jj < RPG; ++jj) acc[jj] = 0u;
    if (n_tiles) stage_rows(XT, Pl, rows, 0, min(TILE_ROWS, nu), mw, chunk);
    for (int t = 0; t < n_tiles; ++t) {
        if (t + 1 < n_tiles) {
            const int r0 = (t + 1) * TILE_ROWS;
            stage_rows(XT + (size_t)((t + 1) & 1) * TILE_ROWS * mw, Pl, rows, r0,
                       min(TILE_ROWS, nu - r0), mw, chunk);
            asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        __syncthreads();
        const uint32_t* Tt = XT + (size_t)(t & 1) * TILE_ROWS * mw;
        if (w < mw) {
#pragma unroll
            for (int qw = 0; qw < TILE_ROWS / 32; ++qw) {
                const uint32_t* gw = Gc + (size_t)(t * (TILE_ROWS / 32) + qw) * K + j0;
#pragma unroll
                for (int jj = 0; jj < RPG; ++jj)
                    for (uint32_t g = gw[jj]; g; g &= g - 1u)
                        acc[jj] ^= Tt[(qw * 32 + __ffs(g) - 1) * mw + w];
            }
        }
        __syncthreads();  // the buffer is restaged two tiles on, or becomes X
    }

    uint32_t* X = XT;
    if (w < mw) {
#pragma unroll
        for (int jj = 0; jj < RPG; ++jj) {
            const int p = pr[j0 + jj];
            const uint32_t e = p < m_pad && (p >> 5) == w ? 1u << (p & 31) : 0u;
            X[(j0 + jj) * mw + w] = acc[jj] ^ e;
        }
    }
    __syncthreads();
    uint32_t* out = Pl + (size_t)scur * mw;
    if (w < mw) {
#pragma unroll
        for (int jj = 0; jj < RPG; ++jj) {
            const uint32_t* li = Li + (j0 + jj) * KW;
            uint32_t r = 0u;
#pragma unroll
            for (int q = 0; q < KW; ++q)
                for (uint32_t bits = li[q]; bits; bits &= bits - 1u)
                    r ^= X[(q * 32 + __ffs(bits) - 1) * mw + w];
            out[(size_t)(j0 + jj) * mw + w] = r;
        }
    }
}

static int launch_check(const void* kernel, size_t smem)
{
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    return (int)err;
}

static int sm_count()
{
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 1;
}

extern "C" int factored_y_launch(
    const void* P, const void* lanes, const void* ids, const void* Hc, void* Y,
    int A, int s_max, int mw, int scur, void* stream)
{
    if (A <= 0 || scur <= 0) return (int)cudaSuccess;
    // the largest tile of rows whose two buffers fit beside the supports
    int rows = Y_TILE_MAX;
    size_t smem = 0;
    for (;; rows >>= 1) {
        smem = sizeof(uint2) * (size_t)K * mw + sizeof(int) * K
             + sizeof(uint32_t) * 2 * (size_t)rows * (mw | 1);
        if (smem <= SMEM_MAX || rows == 32) break;
    }
    int err = launch_check((const void*)factored_y_kernel, smem);
    if (err) return err;
    // split a sample's tiles over blocks only as far as it takes to give
    // every SM two blocks: each block lists the supports once
    const int n_tiles = (scur + rows - 1) / rows;
    const int split = std::min(n_tiles, std::max(1, (2 * sm_count() + A - 1) / A));
    const int per = (n_tiles + split - 1) / split;
    const dim3 grid(A, (n_tiles + per - 1) / per);
    factored_y_kernel<<<grid, 4 * rows, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)P, (const int*)lanes, (const int*)ids, (const uint32_t*)Hc,
        (uint32_t*)Y, s_max, mw, scur, rows, per);
    return (int)cudaGetLastError();
}

extern "C" int factored_w_launch(
    const void* C, const void* lanes, const void* ids, const void* Hc,
    const void* Y, void* W, int A, int cw, int m_pad, int mw, int scur, int rows, void* stream)
{
    if (A <= 0) return (int)cudaSuccess;
    if (m_pad % 32 || rows < 32 || rows > W_THREADS * 4 || (rows & (rows - 1)))
        return (int)cudaErrorInvalidValue;  // a power of two from 32 to 2,048
    if ((uintptr_t)C % 16 || (uintptr_t)Y % 16)  // 16-byte cp.async of C's and Y's rows
        return (int)cudaErrorMisalignedAddress;
    // W_THREADS threads: R = rows / W_THREADS rows a thread for large tiles,
    // W_THREADS / rows slices of C's words for small ones
    const int threads = W_THREADS, R = std::max(1, rows / W_THREADS);
    // C in chunks of whole words over the tile, two buffers when it takes more than one
    const int sw_n = scur / 32, cwords = std::max(1, std::min(sw_n, W_CHUNK_WORDS / rows));
    const int buffers = sw_n > cwords ? 2 : 1;
    const size_t smem = sizeof(uint32_t) * ((size_t)scur * KW + (size_t)buffers * cwords * rows
                                            + (size_t)rows * KW + K);
    const void* kernel = R == 1 ? (const void*)factored_w_kernel<1>
                       : R == 2 ? (const void*)factored_w_kernel<2>
                                : (const void*)factored_w_kernel<4>;
    int err = launch_check(kernel, smem);
    if (err) return err;
    void* args[] = {(void*)&C, (void*)&lanes, (void*)&ids, (void*)&Hc, (void*)&Y, &W,
                    &cw, &m_pad, &mw, &scur, &rows, (void*)&cwords};
    return (int)cudaLaunchKernel(kernel, dim3(A, (m_pad + rows - 1) / rows), dim3(threads), args,
                                 smem, (cudaStream_t)stream);
}

extern "C" int factored_elim_launch(
    const void* W, void* b, void* piv, void* C, const void* lanes, const void* ids,
    void* prow, int A, int m_pad, int cw, int n, int blk, void* stream)
{
    if (A <= 0) return (int)cudaSuccess;
    const int mw = m_pad / 32, nt = (mw + 31) / 32, sms = sm_count();
    if (m_pad % 32 || nt > 8) return (int)cudaErrorInvalidValue;
    // four warps a sample while the samples leave the SMs idle (W in and C
    // out, a serial chain of loads and shuffles for one warp, split four
    // ways); one warp where they fill the card, whose issue the extra warps
    // would only share, and their registers cost a wave
    const int group = A <= 2 * sms ? ELIM_GROUP : 1;
    const size_t per_sample = sizeof(uint32_t) * K * (size_t)(mw | 1);
    // samples a block: spread over the SMs first, then stacked up to what
    // the shared memory holds (at least one: mw <= 256), at most 16 warps
    // and 8 samples (named barriers 1-8)
    const int fit = (int)std::min((size_t)std::min(ELIM_SAMPLES_MAX, 16 / group),
                                  (size_t)SMEM_MAX / per_sample);
    const int samples = std::min(fit, (A + sms - 1) / sms);
    const size_t smem = per_sample * samples;
    const void* kernel = nt == 1 ? (const void*)factored_elim_kernel<1>
                       : nt == 2 ? (const void*)factored_elim_kernel<2>
                       : nt <= 4 ? (const void*)factored_elim_kernel<4>
                                 : (const void*)factored_elim_kernel<8>;
    int err = launch_check(kernel, smem);
    if (err) return err;
    void* args[] = {(void*)&W, &b, &piv, &C, (void*)&lanes, (void*)&ids, &prow,
                    &A, &m_pad, &cw, &n, &blk, (void*)&group};
    return (int)cudaLaunchKernel(kernel, dim3((A + samples - 1) / samples),
                                 dim3(32 * group * samples), args, smem, (cudaStream_t)stream);
}

extern "C" int factored_resolve_launch(
    void* P, const void* C, const void* lanes, const void* prow,
    int A, int s_max, int mw, int cw, int m_pad, int blk, void* stream)
{
    if (A <= 0) return (int)cudaSuccess;
    // warps a row group must span to cover mw words, as a power of two
    int wpg = 1;
    while (wpg * 32 < mw) wpg <<= 1;
    if (wpg > 8) return (int)cudaErrorInvalidValue;
    // the widest cp.async a P row's start allows
    int chunk = 16;
    while (chunk > 4 && ((mw * 4) % chunk || (uintptr_t)P % chunk)) chunk >>= 1;
    const size_t scur = (size_t)blk * K, sw_n = scur / 32;
    const size_t smem = sizeof(uint32_t) * ((size_t)K * mw + K * sw_n + 2 * sw_n + scur);
    const void* kernel = wpg == 1 ? (const void*)factored_resolve_kernel<8>
                       : wpg == 2 ? (const void*)factored_resolve_kernel<16>
                       : wpg == 4 ? (const void*)factored_resolve_kernel<32>
                                  : (const void*)factored_resolve_kernel<64>;
    int err = launch_check(kernel, smem);
    if (err) return err;
    void* args[] = {&P, (void*)&C, (void*)&lanes, (void*)&prow, &s_max, &mw, &cw, &m_pad, &blk, &chunk};
    return (int)cudaLaunchKernel(kernel, dim3(A), dim3(RESOLVE_THREADS), args, smem,
                                 (cudaStream_t)stream);
}
