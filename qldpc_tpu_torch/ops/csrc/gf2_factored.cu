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

#define K 128
#define KW 4
#define Y_ROWS 128
#define W_ROWS 256
#define RESOLVE_THREADS 512
#define RESOLVE_WARPS (RESOLVE_THREADS / 32)
#define TILE_ROWS 64  // staged P rows a buffer; two buffers hold K rows
#define FULL 0xffffffffu
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
