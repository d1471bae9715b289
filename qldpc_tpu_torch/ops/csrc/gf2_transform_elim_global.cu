// Transform GF(2) elimination with T in global memory (K4g).
//
// Computes qldpc_tpu/decoders/osd.py::_eliminate_lanes_T, the JAX package's
// XLA transform elimination of wide systems (not a Pallas kernel: the TPU
// kernel K4 replaces, osd_transform_pallas.py::_kernel, keeps a tile of T
// in VMEM and the JAX decoder leaves it past about 6 MB). It is K4's
// algorithm (gf2_transform_elim.cu: panels of 32 columns, the panel's bits
// of every row on one word, one warp eliminating the panel on the rows
// holding a bit and the 32 from the rank, T updated once a panel from the
// pivots' panel-start rows U) for systems whose T does not fit one block's
// shared memory: 373 KB a sample at the [[144,12,12]] DEM (1,728 rows),
// 3.36 MB at the [[288,12,18]] DEM (5,184 rows), against 227 KB.
//
// T lives in the output buffer, indexed by slot (logical row i in slot
// phys[i], as in K4); everything else K4 keeps stays in shared memory: the
// per-row panel word, mask, piv_col, slot, list row and b, the staged panel
// columns and their word lists (130 KB at 5,184 rows).
//
// What bounds it on the card: T's traffic. Each panel reads, for every row,
// the words of T where a panel column is nonzero (H is sparse: a DEM column
// touches a few detectors), and reads and writes every row a pivot
// eliminates once, whatever the number of pivots (the masks fold them).
// Where T is dense that is about 2 m * m_words words a panel, and one
// sample's panels run in series on one block. The design keeps the reads
// coalesced: a warp takes a row, its lanes the row's words (a lane's share
// of the panel bits, XOR-reduced over the warp in step 2; a lane's words
// of the row in step 4), and the pivot rows U are read from shared memory.
// A block of 512 threads a sample.
//
// At the end T is put in logical order in place: a few words of every row
// at a time are staged in the shared memory the loop no longer needs, then
// written back to the rows whose slot they held. The exits are K4's (at
// every 32nd column: rank(H) reached, or with the b-exit no syndrome bit
// at or below the rank), so T, b, rank and piv_col equal the plain
// version's (ops/osd_transform_cuda.py::eliminate_transform_plain).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gf2_transform_panel.cuh"

#define THREADS 512
#define MAX_ROWS 65536  // slots and list rows are 16-bit

__global__ void __launch_bounds__(THREADS, 2) gf2_transform_elim_global_kernel(
    const int* __restrict__ order, const uint32_t* __restrict__ Hc,
    uint32_t* T_out, int* __restrict__ b_io,
    int* __restrict__ rank_out, int* __restrict__ piv_out,
    int m, int mw, int n, int h_rank, int b_exit)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ int s_src[PANEL];  // slot of each pivot's panel-start row
    __shared__ int s_rank, s_npiv, s_nz;
    const int G = (m + 31) >> 5, m_pad = G * 32;
    const int stride = mw | 1;
    uint32_t* hc = (uint32_t*)smem_raw;              // PANEL * stride, staged columns
    uint32_t* lm = hc + PANEL * stride;              // PANEL * mw, word masks; then cW
    uint32_t* W = lm + PANEL * mw;                   // m_pad panel words; then cM; then U
    uint32_t* Msk = W + m_pad;                       // m_pad, cX; then pivots' U rows of each row
    int* piv = (int*)(Msk + m_pad);                  // m_pad
    uint32_t* s_cols = (uint32_t*)(piv + m_pad);     // mw, the staged columns nonzero in each word
    uint16_t* phys = (uint16_t*)(s_cols + mw);       // m_pad, slot of each logical row
    uint16_t* lab = phys + m_pad;                    // m_pad, the list's logical rows
    uint16_t* nzw = lab + m_pad;                     // mw, the words some panel column touches
    uint8_t* bb = (uint8_t*)(nzw + mw);              // m_pad

    const int s = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5, stager = nwarps - 1;
    const int* ord = order + (size_t)s * n;
    int* b_s = b_io + (size_t)s * m;
    uint32_t* T = T_out + (size_t)s * m * mw;  // row of slot r at T + r * mw

    for (int idx = tid; idx < m * mw; idx += nt) {
        const int i = idx / mw, w = idx - i * mw;
        T[idx] = (i >> 5) == w ? (1u << (i & 31)) : 0u;
    }
    for (int i = tid; i < m_pad; i += nt) {
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
        //    (ascending, a bit each in s_cols[w]) and their masks; the words
        //    with any, listed in nzw
        if (warp == 0) {
            int nz = 0;
            for (int w0 = 0; w0 < mw; w0 += 32) {
                const int w = w0 + lane;
                uint32_t cols = 0;
                if (w < mw) {
                    uint32_t* mk = lm + w * PANEL;
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
                const uint32_t bal = __ballot_sync(FULL, cols != 0u);
                if (cols) nzw[nz + __popc(bal & ((1u << lane) - 1u))] = (uint16_t)w;
                nz += __popc(bal);
            }
            if (lane == 0) s_nz = nz;
        }
        __syncthreads();
        if (warp == stager && col0 + PANEL < n)
            stage_panel(hc, stride, ord, Hc, col0 + PANEL, n, mw, lane);

        // 2. the panel's bits of every logical row: a warp a row, a lane a
        //    listed word, the lanes' bits XORed together
        const int nz = s_nz;
        for (int i = warp; i < m_pad; i += nwarps) {
            uint32_t wv = 0;
            if (i < m) {
                const uint32_t* row = T + (size_t)phys[i] * mw;
                for (int q = lane; q < nz; q += 32) {
                    const int w = nzw[q];
                    const uint32_t x = row[w];
                    const uint32_t* mk = lm + w * PANEL;
                    uint32_t cols = s_cols[w];
                    for (int t = 0; cols; ++t, cols &= cols - 1)
                        wv ^= (uint32_t)(__popc(x & mk[t]) & 1) << (__ffs(cols) - 1);
                }
                wv = __reduce_xor_sync(FULL, wv);
            }
            if (lane == 0) W[i] = wv;
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

        // 4. U (the pivots' panel-start rows) into W, then every row whose
        //    mask is set takes its U rows: a warp a row, a lane a word
        for (int idx = tid; idx < npiv * mw; idx += nt) {
            const int k = idx / mw, w = idx - k * mw;
            W[idx] = T[(size_t)s_src[k] * mw + w];
        }
        __syncthreads();
        for (int i = warp; i < m; i += nwarps) {
            const uint32_t mk = Msk[i];
            if (!mk) continue;
            uint32_t* row = T + (size_t)phys[i] * mw;
            for (int w = lane; w < mw; w += 32) {
                uint32_t x = row[w];
                for (uint32_t bits = mk; bits; bits &= bits - 1) x ^= W[(__ffs(bits) - 1) * mw + w];
                row[w] = x;
            }
        }
        __syncthreads();  // T's rows written before the next panel reads them
    }
    cp_async_wait_all();  // a staged panel the exit left unread
    __syncthreads();

    for (int i = tid; i < m; i += nt) {
        b_s[i] = bb[i];
        piv_out[(size_t)s * m + i] = piv[i];
    }
    if (tid == 0) rank_out[s] = rank;

    // T into logical order: cw words of every slot staged in hc .. Msk (no
    // longer read), then written to the row that slot holds
    uint32_t* stage = hc;
    const int cw = min(mw, (PANEL * stride + PANEL * mw + 2 * m_pad) / m);
    for (int w0 = 0; w0 < mw; w0 += cw) {
        const int c = min(cw, mw - w0);
        for (int idx = tid; idx < m * c; idx += nt) {
            const int r = idx / c, j = idx - r * c;
            stage[idx] = T[(size_t)r * mw + w0 + j];
        }
        __syncthreads();
        for (int idx = tid; idx < m * c; idx += nt) {
            const int i = idx / c, j = idx - i * c;
            T[(size_t)i * mw + w0 + j] = stage[phys[i] * c + j];
        }
        __syncthreads();
    }
}

extern "C" int gf2_transform_elim_global_smem_bytes(int m, int mw)
{
    const size_t m_pad = (size_t)((m + 31) / 32) * 32;
    return (int)(4 * (PANEL * (size_t)(mw | 1) + PANEL * (size_t)mw + 3 * m_pad + mw)
                 + 2 * (2 * m_pad + mw) + m_pad);
}

extern "C" int gf2_transform_elim_global_launch(
    const void* order, const void* Hc, void* T_out, void* b_io,
    void* rank_out, void* piv_out, int B, int m, int mw, int n, int h_rank,
    int b_exit, void* stream_)
{
    const int G = (m + 31) / 32;
    if (m < 1 || G * 32 > MAX_ROWS || mw != G) return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaSuccess;
    const int smem = gf2_transform_elim_global_smem_bytes(m, mw);
    auto kernel = &gf2_transform_elim_global_kernel;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, THREADS, smem, (cudaStream_t)stream_>>>(
        (const int*)order, (const uint32_t*)Hc, (uint32_t*)T_out, (int*)b_io,
        (int*)rank_out, (int*)piv_out, m, mw, n, h_rank, b_exit);
    return (int)cudaGetLastError();
}
