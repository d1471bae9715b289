// Transform GF(2) elimination for wide systems (K4).
//
// Replaces qldpc_tpu/ops/osd_transform_pallas.py::_kernel. A wide system
// (a circuit-level DEM: m = 432 detectors, n = 15765 mechanisms) is never
// row-reduced as a packed (m, n) matrix. Each sample carries only the m x m
// row-operation transform T, bit-packed (m_words words per row), plus the
// residual syndrome b; the RREF bit of (row r, permuted column c) is
// parity(T[r] & Hc[order[c]]), where Hc holds H's columns packed. Pivoting
// is the lanes path's: the first row at or below the rank holding the bit,
// swapped up to the rank row, then XORed into every other row holding it.
//
// What bounds it on the card: the serial chain of pivot columns in each
// sample, not device memory (T lives in shared memory, 25 KB at the
// [[72,12,6]] DEM, 93 KB at the [[144,12,12]] space-time matrix). So the
// design takes the block barriers and the global round trips out of the
// column loop. It works in panels of 32 columns. A row's bit in column c is
// linear in T[r], so the row operations of a whole panel can be found on one
// 32-bit word per row and applied to T once:
//   1. the panel's columns Hc[order[col0 .. col0+31]] were staged into
//      shared memory by cp.async while the previous panel ran; for each word
//      of a row, the columns nonzero there are listed with their masks (H is
//      sparse);
//   2. W[i] = the panel's 32 bits of logical row i, one pass over T;
//   3. one warp eliminates the 32 columns on W alone, __syncwarp only (see
//      eliminate_panel): only the rows holding a panel bit and the 32 rows
//      from the rank take part (a row without a bit is never a candidate and
//      never eliminated); their words are transposed to one column a lane;
//      the swap moves W, b, the row's mask M and its physical slot (T itself
//      never moves: logical row i lives in slot phys[i]). Every row is kept
//      as T0[phys[i]] ^ (the XOR of U_k over the bits k of M[i]), U_k =
//      T0[slot of pivot k] being the panel-start rows of the pivots, so a
//      pivot at its time is U_k ^ (its M) and eliminating row i is M[i] ^=
//      M_pivot ^ e_k: the pivot triangle is folded into the masks;
//   4. U is copied out of T, then every row's slot takes its M's U rows.
// A block holds one sample, of 256 threads up to 512 rows (six blocks an SM:
// the [[72]] DEM's ~716 failures in one wave on 132 SMs), else of 512
// (ops/osd_transform_cuda.py::launch_shape).
//
// Exits, at every 32nd column as in the lanes path (so that T, rank and
// piv_col agree with it, not only the solution): the sample stops once its
// rank reaches rank(H), where every later step is a no-op, or, with the
// b-exit on, once no row at or below the rank carries a syndrome bit: every
// later pivot row would carry b = 0 and add nothing to an OSD-0 solution.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_util.cuh"

#define PANEL 32
#define FULL 0xffffffffu
#define MAX_GROUPS 48  // rows in groups of 32: m <= 1536

__device__ __forceinline__ void cp_async4(void* dst, const void* src)
{
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One warp: the packed columns of panel col0 into hc, lane c's column at
// row c of hc.
__device__ __forceinline__ void stage_panel(
    uint32_t* hc, int stride, const int* __restrict__ ord, const uint32_t* __restrict__ Hc,
    int col0, int n, int mw, int lane)
{
    const int c = col0 + lane;
    if (c >= n) return;
    const uint32_t* src = Hc + (size_t)__ldg(ord + c) * mw;
    uint32_t* dst = hc + lane * stride;
    for (int w = 0; w < mw; ++w) cp_async4(dst + w, src + w);
}

// Step 3: one warp eliminates the panel's columns on W alone.
//
// The list: the logical rows holding a panel bit, and the 32 rows from the
// rank (the only rows a swap can move a pivot to), in logical order; list
// position q stands for logical row lab[q] for the whole panel, its
// contents swap. Position prank + k is the rank row of the panel's k-th
// pivot, logical row rank0 + k. The list is transposed to three column
// vectors a lane, word g of each at [32 g + lane]: cW, lane c the panel's
// column c; cM, lane k the mask bit of pivot k (the rows' masks over U);
// cX, lanes 0-15 a bit of the row's slot and lane 16 its b. Per column j:
// the first position at or after the rank row holding bit j is a minimum
// over the lanes, each reading one word of column j; the swap exchanges two
// bits of every lane's vectors; every other position holding bit j (column
// j without the pivot's bit, read by all lanes) is XORed into each W column
// the pivot row holds a bit of, the M columns of its mask and pivot k, and
// the b column if its b is set. A ballot of the pivot's X bits is its slot.
// The words of a chunk are all read before any is written, so the reads
// overlap. Only __syncwarp.
__device__ __forceinline__ void eliminate_panel(
    uint32_t* W, uint32_t* cW, uint16_t* lab, uint32_t* Msk, uint8_t* bb, uint16_t* phys,
    int* piv, int* s_src, int* s_rank, int* s_npiv, int m, int G, int ncols, int col0,
    int rank0, int lane)
{
    // the list, compacted in place in W (position q <= its row)
    int L = 0, prank = 0;
    for (int g = 0; g < G; ++g) {
        const int i = 32 * g + lane;
        const uint32_t w = W[i];
        const bool in = i < m && (w != 0u || (i >= rank0 && i < rank0 + PANEL));
        const uint32_t bal = __ballot_sync(FULL, in);
        if (in) {
            const int q = L + __popc(bal & ((1u << lane) - 1u));
            W[q] = w;
            lab[q] = (uint16_t)i;
        }
        L += __popc(bal);
        prank += __popc(__ballot_sync(FULL, in && i < rank0));
    }
    const int LG = (L + 31) >> 5;
    __syncwarp();
    uint32_t* cM = W;    // once the list's words are in cW
    uint32_t* cX = Msk;  // the masks are written at the end
    for (int g = 0; g < LG; ++g) {
        const int q = 32 * g + lane;
        uint32_t x = 0, sb = 0;
        if (q < L) {
            const int i = lab[q];
            x = W[q];
            sb = phys[i] | ((uint32_t)bb[i] << 16);
        }
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
    for (int j = 0; j < ncols; ++j) {
        const int pr = prank + k;  // the rank row's position
        int first = 0x7fffffff;
        for (int g = lane; g < LG; g += 32) {
            uint32_t x = cW[32 * g + j];
            const int lo = pr - 32 * g;
            x = lo >= 32 ? 0u : lo > 0 ? x & (FULL << lo) : x;
            if (x && first == 0x7fffffff) first = 32 * g + __ffs(x) - 1;
        }
        const int q = __reduce_min_sync(FULL, first);
        if (q >= L) continue;  // no pivot in this column
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
        const uint32_t sx = __ballot_sync(FULL, hx);  // the pivot's slot, and its b in bit 16
        if (lane == 0) s_src[k] = (int)(sx & 0xffffu);
        if (lane == k) mypiv = col0 + j;
        __syncwarp();  // column j after the swap
        // every other row holding bit j takes the pivot row: its W bits,
        // its mask over U with pivot k, its b
        const bool doW = hw && lane != j, doM = hm || lane == k, doX = lane == 16 && hx;
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

    // each list row's slot and b, then its mask (cM transposed back), to
    // its logical row; rows off the list take no mask
    for (int g = 0; g < LG; ++g) {
        const uint32_t y = transpose32(cX[32 * g + lane], lane);
        const int q = 32 * g + lane;
        if (q < L) {
            const int i = lab[q];
            phys[i] = (uint16_t)(y & 0xffffu);
            bb[i] = (uint8_t)((y >> 16) & 1u);
        }
    }
    __syncwarp();
    for (int i = lane; i < 32 * G; i += 32) Msk[i] = 0u;
    __syncwarp();
    for (int g = 0; g < LG; ++g) {
        const uint32_t y = transpose32(cM[32 * g + lane], lane);
        const int q = 32 * g + lane;
        if (q < L) Msk[lab[q]] = y;
    }
    if (lane < k) piv[rank0 + lane] = mypiv;
    if (lane == 0) {
        *s_rank = rank0 + k;
        *s_npiv = k;
    }
}

// THREADS and MINB bound the registers so that MINB blocks of THREADS
// threads fit an SM.
template <int THREADS, int MINB>
__global__ void __launch_bounds__(THREADS, MINB) gf2_transform_elim_kernel(
    const int* __restrict__ order, const uint32_t* __restrict__ Hc,
    uint32_t* __restrict__ T_out, int* __restrict__ b_io,
    int* __restrict__ rank_out, int* __restrict__ piv_out,
    int m, int mw, int n, int h_rank, int b_exit)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ uint32_t s_cols[MAX_GROUPS];  // the staged columns nonzero in each word
    __shared__ int s_src[PANEL];             // slot of each pivot's panel-start row
    __shared__ int s_rank, s_npiv;
    const int G = (m + 31) >> 5, m_pad = G * 32;
    const int stride = mw | 1;  // odd row stride: no bank conflicts
    uint32_t* T = (uint32_t*)smem_raw;              // m * stride, by slot
    uint32_t* hc = T + (size_t)m * stride;          // PANEL * stride, staged columns
    uint32_t* lm = hc + PANEL * stride;             // PANEL * mw, word masks; then cW
    uint32_t* W = lm + PANEL * mw;                  // m_pad panel words; then cM; then U
    uint32_t* Msk = W + m_pad;                      // m_pad, cX; then pivots' U rows of each row
    int* piv = (int*)(Msk + m_pad);                 // m_pad
    uint16_t* phys = (uint16_t*)(piv + m_pad);      // m_pad, slot of each logical row
    uint16_t* lab = phys + m_pad;                   // m_pad, the list's logical rows
    uint8_t* bb = (uint8_t*)(lab + m_pad);          // m_pad

    const int s = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, stager = (nt >> 5) - 1;
    const int* ord = order + (size_t)s * n;
    int* b_s = b_io + (size_t)s * m;

    for (int i = tid; i < m_pad; i += nt) {
        if (i < m) {
            uint32_t* row = T + (size_t)i * stride;
            for (int w = 0; w < mw; ++w) row[w] = (i >> 5) == w ? (1u << (i & 31)) : 0u;
        }
        bb[i] = i < m ? (uint8_t)b_s[i] : 0;
        piv[i] = -1;
        phys[i] = (uint16_t)i;
    }
    if (warp == stager && n > 0) stage_panel(hc, stride, ord, Hc, 0, n, mw, lane);
    __syncthreads();

    int rank = 0;
    for (int col0 = 0; col0 < n; col0 += PANEL) {
        bool done = rank >= h_rank;
        if (b_exit && !done) {
            int unresolved = 0;
            for (int i = rank + tid; i < m; i += nt) unresolved |= bb[i];
            done = !__syncthreads_or(unresolved);
        }
        if (done) break;
        const int ncols = min(PANEL, n - col0);
        cp_async_wait_all();
        __syncthreads();  // the panel's columns have landed

        // 1. for each word w of a row, the panel's columns nonzero there
        //    (ascending, a bit each in s_cols[w]) and their masks
        if (warp == 0) {
            for (int w = lane; w < mw; w += 32) {
                uint32_t* mk = lm + w * PANEL;
                uint32_t cols = 0;
                int len = 0;
                for (int j = 0; j < ncols; ++j) {
                    const uint32_t x = hc[j * stride + w];
                    if (x) {
                        mk[len++] = x;
                        cols |= 1u << j;
                    }
                }
                s_cols[w] = cols;
            }
        }
        __syncthreads();
        if (warp == stager && col0 + PANEL < n)
            stage_panel(hc, stride, ord, Hc, col0 + PANEL, n, mw, lane);

        // 2. the panel's bits of every logical row: one shared load a term
        for (int i = tid; i < m_pad; i += nt) {
            uint32_t wv = 0;
            if (i < m) {
                const uint32_t* row = T + (size_t)phys[i] * stride;
                for (int w = 0; w < mw; ++w) {
                    const uint32_t x = row[w];
                    const uint32_t* mk = lm + w * PANEL;
                    uint32_t cols = s_cols[w];
                    for (int t = 0; cols; ++t, cols &= cols - 1)
                        wv ^= (uint32_t)(__popc(x & mk[t]) & 1) << (__ffs(cols) - 1);
                }
            }
            W[i] = wv;
        }
        __syncthreads();

        // 3. the panel's pivots on W, one warp
        if (warp == 0)
            eliminate_panel(W, lm, lab, Msk, bb, phys, piv, s_src, &s_rank, &s_npiv, m, G, ncols,
                            col0, rank, lane);
        __syncthreads();
        rank = s_rank;
        const int npiv = s_npiv;
        if (npiv == 0) continue;

        // 4. U (the pivots' panel-start rows) over W, then every row's slot
        for (int idx = tid; idx < npiv * mw; idx += nt) {
            const int k = idx / mw, w = idx - k * mw;
            W[idx] = T[(size_t)s_src[k] * stride + w];
        }
        __syncthreads();
        for (int i = tid; i < m; i += nt) {
            const uint32_t mk = Msk[i];
            if (!mk) continue;
            uint32_t* row = T + (size_t)phys[i] * stride;
            for (int w = 0; w < mw; ++w) {
                uint32_t x = row[w];
                for (uint32_t bits = mk; bits; bits &= bits - 1) x ^= W[(__ffs(bits) - 1) * mw + w];
                row[w] = x;
            }
        }
    }
    cp_async_wait_all();  // a staged panel the exit left unread
    __syncthreads();

    uint32_t* T_s = T_out + (size_t)s * m * mw;
    for (int idx = tid; idx < m * mw; idx += nt) {
        const int i = idx / mw, w = idx - i * mw;
        T_s[idx] = T[(size_t)phys[i] * stride + w];
    }
    for (int i = tid; i < m; i += nt) {
        b_s[i] = bb[i];
        piv_out[(size_t)s * m + i] = piv[i];
    }
    if (tid == 0) rank_out[s] = rank;
}

extern "C" int gf2_transform_elim_smem_bytes(int m, int mw)
{
    const size_t m_pad = (size_t)((m + 31) / 32) * 32;
    return (int)(4 * ((size_t)m * (mw | 1) + PANEL * (mw | 1) + PANEL * mw + 3 * m_pad)
                 + 4 * m_pad + m_pad);
}

// The instances: m <= 512 (the [[72,12,6]] DEM's 432 rows: six blocks of 256
// threads an SM), m <= 1024 (the space-time H_st's 864: two of 512), and
// larger transforms that still fit a block, one of 512.
template <int THREADS, int MINB>
static int launch_instance(
    const void* order, const void* Hc, void* T_out, void* b_io, void* rank_out, void* piv_out,
    int B, int m, int mw, int n, int h_rank, int b_exit, int threads, int smem,
    cudaStream_t stream)
{
    if (threads > THREADS) return (int)cudaErrorInvalidValue;
    auto kernel = &gf2_transform_elim_kernel<THREADS, MINB>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, threads, smem, stream>>>(
        (const int*)order, (const uint32_t*)Hc, (uint32_t*)T_out, (int*)b_io,
        (int*)rank_out, (int*)piv_out, m, mw, n, h_rank, b_exit);
    return (int)cudaGetLastError();
}

extern "C" int gf2_transform_elim_launch(
    const void* order, const void* Hc, void* T_out, void* b_io,
    void* rank_out, void* piv_out, int B, int m, int mw, int n, int h_rank,
    int b_exit, int threads, void* stream_)
{
    const int G = (m + 31) / 32;
    if (threads < 32 || threads % 32 || G > MAX_GROUPS || mw > G)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaSuccess;
    const int smem = gf2_transform_elim_smem_bytes(m, mw);
    cudaStream_t stream = (cudaStream_t)stream_;
    if (G <= 16)
        return launch_instance<256, 6>(order, Hc, T_out, b_io, rank_out, piv_out, B, m, mw, n,
                                       h_rank, b_exit, threads, smem, stream);
    if (G <= 32)
        return launch_instance<512, 2>(order, Hc, T_out, b_io, rank_out, piv_out, B, m, mw, n,
                                       h_rank, b_exit, threads, smem, stream);
    return launch_instance<512, 1>(order, Hc, T_out, b_io, rank_out, piv_out, B, m, mw, n,
                                   h_rank, b_exit, threads, smem, stream);
}
