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
// Design: one block per sample, one thread per row (rows strided over the
// block). T lives in shared memory for the whole elimination (24 KB at the
// [[72,12,6]] DEM), with an odd row stride so that the threads of a warp,
// each walking its own row, hit distinct banks. The TPU kernel streams
// columns that XLA gathered beforehand, because Mosaic cannot gather; here
// the block reads the permuted column Hc[order[b, col]] straight from device
// memory. Bit parity is __popc of the XOR of the ANDed words, and the first
// eligible row is a block minimum (warp __reduce_min_sync, then one warp
// over the per-warp minima).
//
// Exits, at every 32nd column as in the lanes path (so that T, rank and
// piv_col agree with it, not only the solution): the sample stops once its
// rank reaches rank(H), where every later step is a no-op, or, with the
// b-exit on, once no row at or below the rank carries a syndrome bit: every
// later pivot row would carry b = 0 and add nothing to an OSD-0 solution.

#include <cuda_runtime.h>
#include <stdint.h>

#define COL_BLOCK 32

__device__ __forceinline__ int block_min(int v, int* s_warp, int* s_out)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    v = __reduce_min_sync(0xffffffffu, v);
    if (lane == 0) s_warp[warp] = v;
    __syncthreads();
    if (warp == 0) {
        int x = lane < nwarps ? s_warp[lane] : 0x7fffffff;
        x = __reduce_min_sync(0xffffffffu, x);
        if (lane == 0) *s_out = x;
    }
    __syncthreads();
    return *s_out;
}

__global__ void gf2_transform_elim_kernel(
    const int* __restrict__ order, const uint32_t* __restrict__ Hc,
    uint32_t* __restrict__ T_out, int* __restrict__ b_io,
    int* __restrict__ rank_out, int* __restrict__ piv_out,
    int m, int mw, int n, int h_rank, int b_exit)
{
    extern __shared__ uint32_t smem[];
    __shared__ int s_warp[32];
    __shared__ int s_min;
    const int stride = mw | 1;  // odd row stride: no bank conflicts
    uint32_t* T = smem;                       // m * stride
    uint32_t* hc = T + (size_t)m * stride;    // mw
    int* bb = (int*)(hc + mw);                // m
    int* piv = bb + m;                        // m
    int* bits = piv + m;                      // m

    const int s = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    const int* ord = order + (size_t)s * n;
    int* b_s = b_io + (size_t)s * m;

    for (int i = tid; i < m; i += nt) {
        uint32_t* row = T + (size_t)i * stride;
        for (int w = 0; w < mw; ++w)
            row[w] = (i >> 5) == w ? (1u << (i & 31)) : 0u;
        bb[i] = b_s[i];
        piv[i] = -1;
    }
    __syncthreads();

    int rank = 0;
    for (int col0 = 0; col0 < n; col0 += COL_BLOCK) {
        bool done = rank >= h_rank;
        if (b_exit && !done) {
            int unresolved = 0;
            for (int i = rank + tid; i < m; i += nt) unresolved |= bb[i];
            done = !__syncthreads_or(unresolved);
        }
        if (done) break;
        const int col_end = min(col0 + COL_BLOCK, n);
        for (int col = col0; col < col_end; ++col) {
            const uint32_t* hsrc = Hc + (size_t)ord[col] * mw;
            for (int w = tid; w < mw; w += nt) hc[w] = hsrc[w];
            __syncthreads();
            int first = m;
            for (int i = tid; i < m; i += nt) {
                const uint32_t* row = T + (size_t)i * stride;
                uint32_t x = 0;
                for (int w = 0; w < mw; ++w) x ^= row[w] & hc[w];
                const int bit = __popc(x) & 1;
                bits[i] = bit;
                if (bit && i >= rank && i < first) first = i;
            }
            const int p = block_min(first, s_warp, &s_min);
            if (p >= m) continue;  // no pivot in this column
            const int r = rank;
            if (p != r) {
                uint32_t* rp = T + (size_t)p * stride;
                uint32_t* rr = T + (size_t)r * stride;
                for (int w = tid; w < mw; w += nt) {
                    const uint32_t t = rp[w];
                    rp[w] = rr[w];
                    rr[w] = t;
                }
                if (tid == 0) {
                    int t = bb[p]; bb[p] = bb[r]; bb[r] = t;
                    t = bits[p]; bits[p] = bits[r]; bits[r] = t;
                }
            }
            __syncthreads();
            const uint32_t* prow = T + (size_t)r * stride;
            const int pb = bb[r];
            for (int i = tid; i < m; i += nt) {
                if (i == r || !bits[i]) continue;
                uint32_t* row = T + (size_t)i * stride;
                for (int w = 0; w < mw; ++w) row[w] ^= prow[w];
                bb[i] ^= pb;
            }
            if (tid == 0) piv[r] = col;
            __syncthreads();
            ++rank;
        }
    }

    uint32_t* T_s = T_out + (size_t)s * m * mw;
    for (int i = tid; i < m; i += nt) {
        const uint32_t* row = T + (size_t)i * stride;
        for (int w = 0; w < mw; ++w) T_s[(size_t)i * mw + w] = row[w];
        b_s[i] = bb[i];
        piv_out[(size_t)s * m + i] = piv[i];
    }
    if (tid == 0) rank_out[s] = rank;
}

extern "C" int gf2_transform_elim_smem_bytes(int m, int mw)
{
    return (int)(sizeof(uint32_t) * ((size_t)m * (mw | 1) + mw) + 3 * sizeof(int) * (size_t)m);
}

extern "C" int gf2_transform_elim_launch(
    const void* order, const void* Hc, void* T_out, void* b_io,
    void* rank_out, void* piv_out, int B, int m, int mw, int n, int h_rank,
    int b_exit, int threads, void* stream_)
{
    if (threads < 32 || threads > 1024 || threads % 32)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaSuccess;
    const int smem = gf2_transform_elim_smem_bytes(m, mw);
    cudaError_t err = cudaFuncSetAttribute(
        gf2_transform_elim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    gf2_transform_elim_kernel<<<B, threads, smem, (cudaStream_t)stream_>>>(
        (const int*)order, (const uint32_t*)Hc, (uint32_t*)T_out, (int*)b_io,
        (int*)rank_out, (int*)piv_out, m, mw, n, h_rank, b_exit);
    return (int)cudaGetLastError();
}
