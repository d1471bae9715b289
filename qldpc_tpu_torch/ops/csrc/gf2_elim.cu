// Batched GF(2) reduced row echelon form of bit-packed systems [A | b] (K2).
//
// Replaces qldpc_tpu/ops/osd_pallas.py::_elim_kernel, with the same result as
// the lanes elimination of qldpc_tpu/decoders/osd.py::_eliminate_lanes: for
// each column in order, the first row at or below the current rank holding
// the column's bit becomes the pivot, is swapped into row `rank`, and is
// XORed into every other row holding the bit (rows above the rank included,
// so the result is a full RREF). piv_col[rank] = column.
//
// What bounds it on the card: the dependent chain of n column steps per
// sample, each a pivot search, a row swap and an elimination sweep, with
// little arithmetic; device memory is touched once to load and once to
// store. The design gives each sample one warp and keeps its packed system
// in shared memory for the whole elimination (1.4 KB at [[144,12,12]]): the
// pivot search is a __ballot_sync over 32 rows at a time, each lane owns the
// rows lane, lane + 32, ... during elimination, and the row stride is padded
// to an odd word count so the lanes' rows fall in distinct banks. A sample
// stops once its rank reaches max_rank (rank(H) for OSD, where every later
// column step is a no-op). The TPU kernel's one-hot masked reductions
// existed only because Mosaic could not index dynamically.
//
// Words are uint32 bit patterns carried in int32 tensors; column j of a row
// is bit j % 32 of word j / 32.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void gf2_elim_kernel(
    uint32_t* __restrict__ A,    // (B, m, nw), reduced in place
    uint32_t* __restrict__ b,    // (B, m), reduced in place
    int* __restrict__ piv,       // (B, m) out: pivot column of each row, -1 none
    int B, int m, int nw, int n, int max_rank, int rs)
{
    extern __shared__ uint32_t smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int sample = blockIdx.x * (blockDim.x >> 5) + warp;
    if (sample >= B) return;  // whole warp: no block-wide barrier below

    uint32_t* sA = smem + (size_t)warp * (m * rs + 2 * m);
    uint32_t* sb = sA + m * rs;
    int* sp = reinterpret_cast<int*>(sb + m);
    uint32_t* gA = A + (size_t)sample * m * nw;
    uint32_t* gb = b + (size_t)sample * m;

    for (int i = lane; i < m * nw; i += 32) {
        const int r = i / nw, w = i - r * nw;
        sA[r * rs + w] = gA[i];
    }
    for (int r = lane; r < m; r += 32) {
        sb[r] = gb[r];
        sp[r] = -1;
    }
    __syncwarp();

    int rank = 0;
    for (int col = 0; col < n && rank < max_rank; ++col) {
        const int w = col >> 5;
        const uint32_t bit = 1u << (col & 31);
        int p = -1;
        for (int r0 = rank; r0 < m; r0 += 32) {
            const int r = r0 + lane;
            const bool hit = r < m && (sA[r * rs + w] & bit);
            const unsigned mask = __ballot_sync(0xffffffffu, hit);
            if (mask) {
                p = r0 + __ffs(mask) - 1;
                break;
            }
        }
        if (p < 0) continue;  // warp-uniform
        if (p != rank) {
            for (int k = lane; k < nw; k += 32) {
                const uint32_t t = sA[p * rs + k];
                sA[p * rs + k] = sA[rank * rs + k];
                sA[rank * rs + k] = t;
            }
            if (lane == 0) {
                const uint32_t t = sb[p];
                sb[p] = sb[rank];
                sb[rank] = t;
            }
        }
        __syncwarp();
        const uint32_t* prow = sA + rank * rs;
        const uint32_t pb = sb[rank];
        for (int r = lane; r < m; r += 32) {
            if (r != rank && (sA[r * rs + w] & bit)) {
                for (int k = 0; k < nw; ++k) sA[r * rs + k] ^= prow[k];
                sb[r] ^= pb;
            }
        }
        if (lane == 0) sp[rank] = col;
        ++rank;
        __syncwarp();
    }

    for (int i = lane; i < m * nw; i += 32) {
        const int r = i / nw, w = i - r * nw;
        gA[i] = sA[r * rs + w];
    }
    for (int r = lane; r < m; r += 32) {
        gb[r] = sb[r];
        piv[(size_t)sample * m + r] = sp[r];
    }
}

extern "C" int gf2_elim_launch(
    void* A, void* b, void* piv, int B, int m, int nw, int n, int max_rank,
    int warps_per_block, void* stream)
{
    if (warps_per_block < 1 || warps_per_block > 32)
        return (int)cudaErrorInvalidValue;
    const int rs = nw | 1;  // odd row stride: conflict-free row-per-lane access
    const size_t smem =
        (size_t)warps_per_block * (m * rs + 2 * m) * sizeof(uint32_t);
    // opt in for every size: the kernel's static shared memory counts
    // against the same 48 KB default as the dynamic part
    cudaError_t err = cudaFuncSetAttribute(
        gf2_elim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (B + warps_per_block - 1) / warps_per_block;
    if (blocks > 0) {
        gf2_elim_kernel<<<blocks, 32 * warps_per_block, smem,
                          (cudaStream_t)stream>>>(
            (uint32_t*)A, (uint32_t*)b, (int*)piv, B, m, nw, n, max_rank, rs);
    }
    return (int)cudaGetLastError();
}
