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
//   K5a  one thread per frozen pivot row s: the block's 128 packed columns
//        (27 KB) and a tile of 128 P rows sit in shared memory; each output
//        word is 32 accumulators of x ^= P[s][w] & H[k][w] (one LOP3 per
//        word and column) and then one __popc parity per column;
//   K5b  one thread per row r: the block's Y (up to 37 KB) in shared memory,
//        read as warp broadcasts; C is word-major with the rows minor, so a
//        warp reads 32 rows' coefficient words in one transaction, and a
//        word that is zero for the whole warp is skipped;
//   K5c  one block per sample: W and the new coefficients in shared memory,
//        word-major, a thread per row; the first candidate row is a block
//        minimum, as in K4; b and the pivoted flags are packed back with
//        __ballot_sync;
//   K5d  one block per sample: P_new (27 KB), the pivots' C rows and a
//        32-row tile of P in shared memory; the intra-block triangle is
//        resolved serially over j2 in pivot order.
// The TPU kernels' VMEM budget models, 128-lane slabs and the XLA row
// gathers around them (Mosaic cannot gather) are not carried over: each
// kernel gathers its own columns and rows.

#include <cuda_runtime.h>
#include <stdint.h>

#define K 128
#define KW 4
#define Y_ROWS 128
#define W_ROWS 256
#define TILE 32
#define RESOLVE_THREADS 512
#define SMEM_MAX 232448

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

// K5a: Y[a][s][q] bit kk = parity(P[lane][s] & Hc[ids[a][32 q + kk]]), s < scur.
__global__ void factored_y_kernel(
    const uint32_t* __restrict__ P, const int* __restrict__ lanes,
    const int* __restrict__ ids, const uint32_t* __restrict__ Hc,
    uint32_t* __restrict__ Y, int s_max, int mw, int scur)
{
    extern __shared__ __align__(16) uint32_t smem[];
    const int stride = mw | 1;               // odd: a thread per row, no bank conflicts
    uint32_t* Ht = smem;                     // mw x K: word w of block column k
    uint32_t* Ps = Ht + (size_t)mw * K;      // Y_ROWS x stride
    const int a = blockIdx.x, tid = threadIdx.x;
    const int s0 = blockIdx.y * Y_ROWS;
    const int rows = min(Y_ROWS, scur - s0);
    const size_t lane = (size_t)lanes[a];

    const uint32_t* col = Hc + (size_t)ids[(size_t)a * K + tid] * mw;  // tid < K
    for (int w = 0; w < mw; ++w) Ht[w * K + tid] = col[w];
    const uint32_t* src = P + (lane * s_max + s0) * mw;
    for (int i = tid; i < rows * mw; i += Y_ROWS) {
        const int r = i / mw;
        Ps[r * stride + (i - r * mw)] = src[i];
    }
    __syncthreads();
    if (tid >= rows) return;

    const uint32_t* row = Ps + tid * stride;
    uint32_t* out = Y + ((size_t)a * scur + s0 + tid) * KW;
    for (int q = 0; q < KW; ++q) {
        uint32_t x[32];
#pragma unroll
        for (int kk = 0; kk < 32; ++kk) x[kk] = 0u;
        for (int w = 0; w < mw; ++w) {
            const uint32_t pw = row[w];
            const uint4* h4 = reinterpret_cast<const uint4*>(Ht + w * K + q * 32);
#pragma unroll
            for (int v = 0; v < 8; ++v) {
                const uint4 h = h4[v];
                x[4 * v] ^= pw & h.x;
                x[4 * v + 1] ^= pw & h.y;
                x[4 * v + 2] ^= pw & h.z;
                x[4 * v + 3] ^= pw & h.w;
            }
        }
        uint32_t word = 0u;
#pragma unroll
        for (int kk = 0; kk < 32; ++kk) word |= (uint32_t)(__popc(x[kk]) & 1) << kk;
        out[q] = word;
    }
}

// K5b: W[a][r] = (H bits of row r in the block's columns) ^ XOR_{s < scur,
// C[lane][s / 32][r] bit s % 32} Y[a][s].
__global__ void factored_w_kernel(
    const uint32_t* __restrict__ C, const int* __restrict__ lanes,
    const int* __restrict__ ids, const uint32_t* __restrict__ Hc,
    const uint32_t* __restrict__ Y, uint32_t* __restrict__ W,
    int cw, int m_pad, int mw, int scur)
{
    extern __shared__ __align__(16) uint32_t smem[];
    uint32_t* Ys = smem;                                  // scur x KW
    int* ids_s = reinterpret_cast<int*>(Ys + (size_t)scur * KW);  // K
    const int a = blockIdx.x, tid = threadIdx.x;
    const size_t lane = (size_t)lanes[a];
    const uint32_t* Ya = Y + (size_t)a * scur * KW;
    for (int i = tid; i < scur * KW; i += blockDim.x) Ys[i] = Ya[i];
    for (int k = tid; k < K; k += blockDim.x) ids_s[k] = ids[(size_t)a * K + k];
    __syncthreads();
    const int r = blockIdx.y * W_ROWS + tid;
    if (r >= m_pad) return;  // m_pad is a multiple of 32: whole warps leave

    const int rw = r >> 5, rb = r & 31;
    uint32_t acc[KW];
    for (int q = 0; q < KW; ++q) {
        uint32_t word = 0u;
        for (int kk = 0; kk < 32; ++kk)
            word |= ((Hc[(size_t)ids_s[q * 32 + kk] * mw + rw] >> rb) & 1u) << kk;
        acc[q] = word;
    }
    const uint32_t* Cr = C + lane * cw * m_pad + r;  // word sw at Cr[sw * m_pad]
    for (int sw = 0; sw < (scur >> 5); ++sw) {
        const uint32_t c = Cr[(size_t)sw * m_pad];
        if (!__any_sync(0xffffffffu, c != 0u)) continue;
        const uint4* y4 = reinterpret_cast<const uint4*>(Ys + (size_t)sw * 32 * KW);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const uint32_t mask = 0u - ((c >> i) & 1u);
            const uint4 v = y4[i];
            acc[0] ^= v.x & mask;
            acc[1] ^= v.y & mask;
            acc[2] ^= v.z & mask;
            acc[3] ^= v.w & mask;
        }
    }
    reinterpret_cast<uint4*>(W)[(size_t)a * m_pad + r] = make_uint4(acc[0], acc[1], acc[2], acc[3]);
}

// K5c: the block's K columns eliminated in order on [W | b] with implicit
// pivots. b, piv (packed by row) and C's block columns are updated for the
// sample; prow gets each column's pivot row, m_pad where none.
__global__ void factored_elim_kernel(
    const uint32_t* __restrict__ W, uint32_t* __restrict__ b,
    uint32_t* __restrict__ piv, uint32_t* __restrict__ C,
    const int* __restrict__ lanes, const int* __restrict__ ids,
    int* __restrict__ prow_out, int m_pad, int cw, int n, int blk)
{
    extern __shared__ __align__(16) uint32_t smem[];
    __shared__ int s_warp[32];
    __shared__ int s_min;
    __shared__ int prow_s[K];
    uint32_t* Ws = smem;                                   // KW x m_pad
    uint32_t* cn = Ws + (size_t)KW * m_pad;                // KW x m_pad
    uint8_t* bs = reinterpret_cast<uint8_t*>(cn + (size_t)KW * m_pad);  // m_pad
    uint8_t* pv = bs + m_pad;                              // m_pad
    const int a = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    const size_t lane = (size_t)lanes[a];
    const int mw = m_pad >> 5;
    const uint4* Wa = reinterpret_cast<const uint4*>(W) + (size_t)a * m_pad;
    uint32_t* b_l = b + lane * mw;
    uint32_t* piv_l = piv + lane * mw;

    for (int r = tid; r < m_pad; r += nt) {
        const uint4 v = Wa[r];
        Ws[r] = v.x;
        Ws[m_pad + r] = v.y;
        Ws[2 * m_pad + r] = v.z;
        Ws[3 * m_pad + r] = v.w;
        for (int w = 0; w < KW; ++w) cn[w * m_pad + r] = 0u;
        bs[r] = (b_l[r >> 5] >> (r & 31)) & 1u;
        pv[r] = (piv_l[r >> 5] >> (r & 31)) & 1u;
    }
    __syncthreads();

    for (int j = 0; j < K; ++j) {
        const int w = j >> 5, i = j & 31;
        const uint32_t* col = Ws + w * m_pad;
        int first = m_pad;
        if (ids[(size_t)a * K + j] < n) {
            for (int r = tid; r < m_pad; r += nt)
                if (((col[r] >> i) & 1u) && !pv[r]) { first = r; break; }
        }
        const int p = block_min(first, s_warp, &s_min);
        if (p < m_pad) {
            // row p is read by all and written by none in this step
            const uint32_t w0 = Ws[p], w1 = Ws[m_pad + p];
            const uint32_t w2 = Ws[2 * m_pad + p], w3 = Ws[3 * m_pad + p];
            const uint8_t bp = bs[p];
            for (int r = tid; r < m_pad; r += nt) {
                if (r == p || !((col[r] >> i) & 1u)) continue;
                Ws[r] ^= w0;
                Ws[m_pad + r] ^= w1;
                Ws[2 * m_pad + r] ^= w2;
                Ws[3 * m_pad + r] ^= w3;
                bs[r] ^= bp;
                cn[w * m_pad + r] |= 1u << i;
            }
            if (tid == 0) pv[p] = 1;
        }
        if (tid == 0) prow_s[j] = p;
        __syncthreads();
    }

    uint32_t* Cb = C + (lane * cw + (size_t)blk * KW) * m_pad;
    for (int r = tid; r < m_pad; r += nt) {
        // a warp holds 32 consecutive rows: one packed word each
        const uint32_t bw = __ballot_sync(0xffffffffu, bs[r]);
        const uint32_t pw = __ballot_sync(0xffffffffu, pv[r]);
        if ((tid & 31) == 0) {
            b_l[r >> 5] = bw;
            piv_l[r >> 5] = pw;
        }
        for (int w = 0; w < KW; ++w) Cb[(size_t)w * m_pad + r] = cn[w * m_pad + r];
    }
    for (int j = tid; j < K; j += nt) prow_out[(size_t)a * K + j] = prow_s[j];
}

// K5d: P[lane][scur + j] = e_{prow[j]} ^ XOR_{s < scur, G[j][s]} P[lane][s]
// ^ XOR_{j2 < j, D[j][j2]} P_new[j2], G and D the C rows of the pivots.
__global__ void factored_resolve_kernel(
    uint32_t* __restrict__ P, const uint32_t* __restrict__ C,
    const int* __restrict__ lanes, const int* __restrict__ prow,
    int s_max, int mw, int cw, int m_pad, int blk)
{
    extern __shared__ __align__(16) uint32_t smem[];
    __shared__ int pr[K];
    const int scur = blk * K, sw_n = scur >> 5;
    uint32_t* Pn = smem;                         // K x mw
    uint32_t* G = Pn + (size_t)K * mw;           // K x sw_n
    uint32_t* Pt = G + (size_t)K * sw_n;         // TILE x mw
    uint32_t* D = Pt + (size_t)TILE * mw;        // K x KW
    const int a = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    const size_t lane = (size_t)lanes[a];
    const uint32_t* Cl = C + lane * cw * m_pad;
    uint32_t* Pl = P + lane * s_max * mw;

    for (int j = tid; j < K; j += nt) pr[j] = prow[(size_t)a * K + j];
    __syncthreads();
    for (int i = tid; i < K * sw_n; i += nt) {
        const int j = i / sw_n, p = pr[j];
        G[i] = p < m_pad ? Cl[(size_t)(i - j * sw_n) * m_pad + p] : 0u;
    }
    for (int i = tid; i < K * KW; i += nt) {
        const int j = i / KW, p = pr[j];
        D[i] = p < m_pad ? Cl[(size_t)(blk * KW + (i - j * KW)) * m_pad + p] : 0u;
    }
    for (int i = tid; i < K * mw; i += nt) Pn[i] = 0u;
    __syncthreads();

    for (int t0 = 0; t0 < scur; t0 += TILE) {
        for (int i = tid; i < TILE * mw; i += nt) Pt[i] = Pl[(size_t)t0 * mw + i];
        __syncthreads();
        const int tw = t0 >> 5;
        for (int i = tid; i < K * mw; i += nt) {
            const int j = i / mw, w = i - j * mw;
            const uint32_t g = G[j * sw_n + tw];
            if (!g) continue;
            uint32_t x = Pn[i];
#pragma unroll
            for (int q = 0; q < TILE; ++q) x ^= Pt[q * mw + w] & (0u - ((g >> q) & 1u));
            Pn[i] = x;
        }
        __syncthreads();
    }

    for (int j = tid; j < K; j += nt) {
        const int p = pr[j];
        if (p < m_pad) Pn[j * mw + (p >> 5)] ^= 1u << (p & 31);
    }
    __syncthreads();
    // strictly lower triangle in pivot order: row j2 is final before any
    // later row reads it
    for (int j2 = 0; j2 < K - 1; ++j2) {
        const uint32_t* src = Pn + j2 * mw;
        for (int i = (j2 + 1) * mw + tid; i < K * mw; i += nt) {
            const int j = i / mw;
            if ((D[j * KW + (j2 >> 5)] >> (j2 & 31)) & 1u) Pn[i] ^= src[i - j * mw];
        }
        __syncthreads();
    }

    uint32_t* out = Pl + (size_t)scur * mw;
    for (int i = tid; i < K * mw; i += nt) out[i] = Pn[i];
}

static int launch_check(const void* kernel, size_t smem)
{
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    return (int)err;
}

extern "C" int factored_y_launch(
    const void* P, const void* lanes, const void* ids, const void* Hc, void* Y,
    int A, int s_max, int mw, int scur, void* stream)
{
    if (A <= 0 || scur <= 0) return (int)cudaSuccess;
    const size_t smem = sizeof(uint32_t) * ((size_t)mw * K + (size_t)Y_ROWS * (mw | 1));
    int err = launch_check((const void*)factored_y_kernel, smem);
    if (err) return err;
    const dim3 grid(A, (scur + Y_ROWS - 1) / Y_ROWS);
    factored_y_kernel<<<grid, Y_ROWS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)P, (const int*)lanes, (const int*)ids, (const uint32_t*)Hc,
        (uint32_t*)Y, s_max, mw, scur);
    return (int)cudaGetLastError();
}

extern "C" int factored_w_launch(
    const void* C, const void* lanes, const void* ids, const void* Hc,
    const void* Y, void* W, int A, int cw, int m_pad, int mw, int scur, void* stream)
{
    if (A <= 0) return (int)cudaSuccess;
    if (m_pad % 32) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(uint32_t) * ((size_t)scur * KW + K);
    int err = launch_check((const void*)factored_w_kernel, smem);
    if (err) return err;
    const dim3 grid(A, (m_pad + W_ROWS - 1) / W_ROWS);
    factored_w_kernel<<<grid, W_ROWS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)C, (const int*)lanes, (const int*)ids, (const uint32_t*)Hc,
        (const uint32_t*)Y, (uint32_t*)W, cw, m_pad, mw, scur);
    return (int)cudaGetLastError();
}

extern "C" int factored_elim_launch(
    const void* W, void* b, void* piv, void* C, const void* lanes, const void* ids,
    void* prow, int A, int m_pad, int cw, int n, int blk, int threads, void* stream)
{
    if (A <= 0) return (int)cudaSuccess;
    if (m_pad % 32 || threads < 32 || threads > 1024 || threads % 32)
        return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(uint32_t) * 2 * KW * (size_t)m_pad + 2 * (size_t)m_pad;
    int err = launch_check((const void*)factored_elim_kernel, smem);
    if (err) return err;
    factored_elim_kernel<<<A, threads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)W, (uint32_t*)b, (uint32_t*)piv, (uint32_t*)C,
        (const int*)lanes, (const int*)ids, (int*)prow, m_pad, cw, n, blk);
    return (int)cudaGetLastError();
}

extern "C" int factored_resolve_launch(
    void* P, const void* C, const void* lanes, const void* prow,
    int A, int s_max, int mw, int cw, int m_pad, int blk, void* stream)
{
    if (A <= 0) return (int)cudaSuccess;
    const size_t sw_n = (size_t)blk * K / 32;
    const size_t smem = sizeof(uint32_t) * ((size_t)K * mw + K * sw_n + (size_t)TILE * mw + K * KW);
    int err = launch_check((const void*)factored_resolve_kernel, smem);
    if (err) return err;
    factored_resolve_kernel<<<A, RESOLVE_THREADS, smem, (cudaStream_t)stream>>>(
        (uint32_t*)P, (const uint32_t*)C, (const int*)lanes, (const int*)prow,
        s_max, mw, cw, m_pad, blk);
    return (int)cudaGetLastError();
}
