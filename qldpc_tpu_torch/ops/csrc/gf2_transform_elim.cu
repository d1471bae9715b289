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

#include "gf2_transform_panel.cuh"

#define MAX_GROUPS 48  // rows in groups of 32: m <= 1536

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
