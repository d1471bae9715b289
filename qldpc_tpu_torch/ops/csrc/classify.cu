// Classification of a decoded batch into the Monte-Carlo counters (K9).
//
// Replaces no Pallas kernel: the JAX package's qldpc_tpu/mc/engine.py
// _classify is XLA code. It computes what MonteCarloEngine._classify_plain
// computes, every field an exact integer sum: with residual r = e xor f
// (e the errors, f the final correction, both (batch, n_vars) bits), the
// logical test L fold(r) != 0, the mismatch e != f over all n_vars, the
// syndrome test H f == syn, the weights |fold(r)| and |fold(e)| (the fold
// XORs the T rounds of the data part, v = t*n + j, into qubit j; T = 1 is
// the identity), 2|fold(e)| < d, BP-only logic, the valid mask (a byte a
// sample), the sum of BP's iterations and the four histograms of |fold(r)|
// clamped to the last bin. osd_overflow is added as given.
//
// What bounds it on the card: bytes. The errors, the correction and the
// syndrome are read once; everything else is a few bytes a sample or a
// table of the matrix that stays in the cache. The plain version is about
// 85 torch launches, int32 and float32 copies of the (batch, n_vars)
// arrays, and the syndrome check as a dense float32 product with H (at
// space time the 864 x 2,592 H_st, 6,840 nonzeros). Here a group of
// threads takes a sample (a warp where a row has at most 4,096 variables,
// the block past that) and walks its row and its syndrome once, together,
// as aligned 8-byte words, U words of each a thread a step with every load
// of a step issued before any is used: the time of a sample is a few memory
// latencies, so the bytes in flight are what counts. A word's bits are
// visited only where set. Corrections and residuals are sparse, so each set
// bit of f XORs its column's check list into a bitmap of the m checks in
// shared memory (H f never formed densely), each set bit of syn its own
// check, and the syndrome test is that the bitmap ends at zero; each set
// bit of r and e flips its qubit in a bitmap of the n qubits, which folds
// the rounds. The weights are popcounts of the qubit bitmaps, the logical
// test the XOR of the logicals' bitmask (bit i: row i of L) of each set
// qubit of fold(r).
// Counts gather in the group's first thread, bins in shared memory; each
// block adds every nonzero field into the int64 output with one integer
// atomic, whose order cannot change the sum.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_util.cuh"

#define K9_THREADS 256
#define K9_FIELDS 13  // the scalar counters, osd_overflow at 11
#define K9_BINS 128
#define K9_OUT (K9_FIELDS + 4 * K9_BINS)
#define K9_LOW 0x0101010101010101ull  // the low bit of each byte
#define K9_OVERFLOW 11

struct K9Args {
    const uint8_t* errors;
    const uint8_t* final_;
    const uint8_t* syn;
    const uint8_t* conv;
    const int* iters;
    const uint8_t* valid;
    const int* col_ptr;    // (n_vars + 1,) column CSR of H
    const int* col_idx;
    const unsigned long long* lmask;  // (n,) the logicals of each qubit
    unsigned long long* out;
    int batch, n_vars, m, n, T, distance, bp_only;
    long long overflow;
};

// A sample's row of bytes as the aligned 8-byte words that cover it: word
// q holds the row's bytes first(q) .. first(q) + 7 (the first word may
// start up to 7 bytes before the row, the last end after it; inside(q)
// keeps the row's bytes). The words of two arrays at the same offset
// modulo 8 line up byte for byte.
struct Row {
    const uint64_t* base;  // the first word
    int lead;              // the row's bytes before its start in the first word
    int len, words;

    __device__ __forceinline__ uint64_t word(int q) const { return base[q]; }
    __device__ __forceinline__ int first(int q) const { return 8 * q - lead; }
    __device__ __forceinline__ uint64_t inside(int q) const
    {
        const int lo = first(q), hi = lo + 8;
        uint64_t keep = ~0ull;
        if (lo < 0) keep <<= 8 * -lo;
        if (hi > len) keep &= ~0ull >> 8 * (hi - len);
        return keep;
    }
};

__device__ __forceinline__ Row row(const uint8_t* data, int s, int len)
{
    const uintptr_t start = (uintptr_t)(data + (size_t)s * len);
    const uintptr_t first = start & ~(uintptr_t)7, last = (start + len - 1) & ~(uintptr_t)7;
    return {(const uint64_t*)first, (int)(start - first), len, (int)((last - first) / 8) + 1};
}

__device__ __forceinline__ void flip(uint32_t* bits, int i)
{
    atomicXor(bits + (i >> 5), 1u << (i & 31));
}

// GW warps a sample: 1 (a warp each, 8 samples a block at a time) or 8 (the block)
template <int GW>
__device__ __forceinline__ void group_sync()
{
    if constexpr (GW == 1)
        __syncwarp();
    else
        __syncthreads();
}

// U words of each array a thread a step
template <int GW, int U>
__global__ void __launch_bounds__(K9_THREADS, 4) classify_kernel(const K9Args a)
{
    constexpr int G = 32 * GW, GROUPS = K9_THREADS / G;
    extern __shared__ uint32_t bitmaps[];
    __shared__ unsigned long long s_cnt[K9_FIELDS];
    __shared__ uint32_t s_hist[4 * K9_BINS];
    __shared__ unsigned long long s_lm[GW];
    __shared__ uint32_t s_red[GW][4];

    for (int i = threadIdx.x; i < 4 * K9_BINS; i += K9_THREADS) s_hist[i] = 0;
    if (threadIdx.x < K9_FIELDS) s_cnt[threadIdx.x] = 0;
    __syncthreads();

    const int gt = threadIdx.x % G, group = threadIdx.x / G;
    const int wm = (a.m + 31) >> 5, wn = (a.n + 31) >> 5;
    uint32_t* const sb = bitmaps + group * (wm + 2 * wn);  // checks of H f
    uint32_t* const rq = sb + wm;                           // qubits of fold(r)
    uint32_t* const eq = rq + wn;                           // qubits of fold(e)
    const int data = a.n * a.T;

    // the group's first thread: its samples' counts
    uint32_t c[K9_FIELDS] = {};
    unsigned long long iters = 0;

    for (int s = blockIdx.x * GROUPS + group; s < a.batch; s += gridDim.x * GROUPS) {
        if (!a.valid[s]) continue;
        // the leader's flag and iterations are in flight across the barriers
        const bool conv = gt == 0 && a.conv[s] != 0;
        const int its = gt == 0 ? a.iters[s] : 0;
        const Row e = row(a.errors, s, a.n_vars), f = row(a.final_, s, a.n_vars);
        const Row y = row(a.syn, s, a.m);
        group_sync<GW>();  // the previous sample's bitmaps are read
        for (int w = gt; w < wm + 2 * wn; w += G) sb[w] = 0;
        group_sync<GW>();

        // one pass over the row and the syndrome in aligned 8-byte words, U
        // words of each a thread a step, every load of a step issued before
        // any is used: each set bit of f XORs its check list into the check
        // bitmap and each set bit of syn its check, so the bitmap ends as
        // H f + syn; each set bit of r and e in the data part flips its qubit
        uint64_t mis = 0;
        for (int q0 = gt; q0 < e.words || q0 < y.words; q0 += G * U) {
            uint64_t ev[U], fv[U], yv[U];
            unrolled<U>([&](auto u) {
                const int q = q0 + u * G;
                ev[u] = q < e.words ? e.word(q) : 0;
                fv[u] = q < e.words ? f.word(q) : 0;
                yv[u] = q < y.words ? y.word(q) : 0;
            });
            unrolled<U>([&](auto u) {
                const int q = q0 + u * G, k = e.first(q);
                const uint64_t in = e.inside(q), ew = ev[u] & in, fw = fv[u] & in;
                mis |= ew ^ fw;
                for (uint64_t b = fw & K9_LOW; b; b &= b - 1) {
                    const int v = k + (__ffsll(b) - 1) / 8;
                    for (int c = a.col_ptr[v]; c < a.col_ptr[v + 1]; ++c) flip(sb, a.col_idx[c]);
                }
                for (uint64_t b = (ew | fw) & K9_LOW; b; b &= b - 1) {
                    const int byte = (__ffsll(b) - 1) / 8, v = k + byte;
                    if (v >= data) break;
                    const int j = a.T == 1 ? v : v % a.n;
                    if ((ew ^ fw) >> (8 * byte) & 1) flip(rq, j);
                    if (ew >> (8 * byte) & 1) flip(eq, j);
                }
                for (uint64_t b = yv[u] & y.inside(q) & K9_LOW; b; b &= b - 1)
                    flip(sb, y.first(q) + (__ffsll(b) - 1) / 8);
            });
        }
        group_sync<GW>();

        uint32_t bad = 0, rw = 0, ew = 0;
        unsigned long long lm = 0;
        for (int w = gt; w < wm; w += G) bad |= sb[w];
        for (int w = gt; w < wn; w += G) {
            uint32_t rb = rq[w];
            rw += __popc(rb);
            ew += __popc(eq[w]);
            for (; rb; rb &= rb - 1) lm ^= a.lmask[w * 32 + __ffs(rb) - 1];
        }
        // reduce over the warp, then (GW = 8) over the block
#pragma unroll
        for (int o = 16; o; o >>= 1) lm ^= __shfl_xor_sync(0xffffffffu, lm, o);
        rw = __reduce_add_sync(0xffffffffu, rw);
        ew = __reduce_add_sync(0xffffffffu, ew);
        mis = __any_sync(0xffffffffu, mis != 0);
        bad = __any_sync(0xffffffffu, bad != 0);
        if constexpr (GW > 1) {
            const int wid = gt >> 5;
            if ((gt & 31) == 0) {
                s_lm[wid] = lm;
                s_red[wid][0] = rw;
                s_red[wid][1] = ew;
                s_red[wid][2] = mis;
                s_red[wid][3] = bad;
            }
            __syncthreads();
            if (gt == 0) {
                for (int k = 1; k < GW; ++k) {
                    lm ^= s_lm[k];
                    rw += s_red[k][0];
                    ew += s_red[k][1];
                    mis |= s_red[k][2];
                    bad |= s_red[k][3];
                }
            }
        }
        if (gt == 0) {
            const bool vec_logical = lm != 0;
            const bool logical = vec_logical || (a.bp_only && !conv);
            const bool low = 2 * (long long)ew < a.distance;
            const bool degenerate = !logical && mis;
            c[0] += 1;
            c[1] += logical;
            c[2] += vec_logical;
            c[3] += conv;
            c[4] += !conv;
            c[5] += !a.bp_only && !conv;
            c[6] += logical && low;
            c[7] += logical && !low;
            c[8] += degenerate;
            c[9] += degenerate && !bad;
            c[10] += logical && !conv;
            iters += (unsigned long long)(long long)its;
            const int bin = rw < K9_BINS - 1 ? rw : K9_BINS - 1;
            if (degenerate) atomicAdd(s_hist + (conv ? 0 : 1) * K9_BINS + bin, 1u);
            if (logical) atomicAdd(s_hist + (conv ? 2 : 3) * K9_BINS + bin, 1u);
        }
    }

    if (gt == 0) {
        for (int k = 0; k < K9_FIELDS - 2; ++k)
            if (c[k]) atomicAdd(s_cnt + k, (unsigned long long)c[k]);
        if (iters) atomicAdd(s_cnt + K9_FIELDS - 1, iters);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < K9_OUT; i += K9_THREADS) {
        unsigned long long v = i < K9_FIELDS ? s_cnt[i] : s_hist[i - K9_FIELDS];
        if (i == K9_OVERFLOW && blockIdx.x == 0) v += (unsigned long long)a.overflow;
        if (v) atomicAdd(a.out + i, v);
    }
}

// Shared memory a block takes: a bitmap of the m checks and two of the n
// qubits for each of its samples in flight.
static size_t smem_bytes(int m, int n, int warps)
{
    return (size_t)(K9_THREADS / (32 * warps)) * (((m + 31) >> 5) + 2 * ((n + 31) >> 5)) * 4;
}

// A block a group of samples in flight, as many blocks as the device holds
// at once (the groups step over the batch past them), at least one (block 0
// adds the overflow). The blocks an SM holds are asked once a shared memory
// size.
template <int GW, int U>
static cudaError_t launch(const K9Args& a, int sm_count, size_t smem, cudaStream_t stream)
{
    static int resident = 0;
    static size_t resident_smem = 0;
    cudaError_t err;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(classify_kernel<GW, U>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    if (resident == 0 || smem != resident_smem) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, classify_kernel<GW, U>,
                                                            K9_THREADS, smem);
        if (err != cudaSuccess) return err;
        if (resident < 1) return cudaErrorInvalidConfiguration;
        resident_smem = smem;
    }
    const long long groups = K9_THREADS / (32 * GW);
    const long long blocks = (a.batch + groups - 1) / groups;
    const int grid = (int)(blocks < 1 ? 1 : blocks < (long long)resident * sm_count
                                                ? blocks : (long long)resident * sm_count);
    classify_kernel<GW, U><<<grid, K9_THREADS, smem, stream>>>(a);
    return cudaGetLastError();
}

// out: (13 + 4 * 128,) int64, zeroed here; errors, final_ (batch, n_vars),
// syn (batch, m), conv, valid (batch,) bytes; iters (batch,) int32; warps a
// sample and the words a thread a step from the wrapper's launch_shape
// ((1, 1), (1, 4) or (8, 4)); sm_count the device's multiprocessors.
// Returns the cudaError_t of the launch.
extern "C" int classify_launch(void* out, const void* errors, const void* final_,
                               const void* syn, const void* conv, const void* iters,
                               const void* valid, const void* col_ptr, const void* col_idx,
                               const void* lmask, int batch, int n_vars, int m, int n, int T,
                               int distance, int bp_only, long long overflow, int warps,
                               int unroll, int sm_count, void* stream_)
{
    if (batch < 0 || n_vars < 1 || m < 1 || n < 1 || T < 1 || (long long)n * T > n_vars
        || sm_count < 1 || (warps != 1 && warps != K9_THREADS / 32) || (unroll != 1 && unroll != 4)
        || (warps != 1 && unroll != 4))
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_;
    cudaError_t err = cudaMemsetAsync(out, 0, K9_OUT * sizeof(long long), stream);
    if (err != cudaSuccess) return (int)err;
    const K9Args a = {(const uint8_t*)errors, (const uint8_t*)final_, (const uint8_t*)syn,
                      (const uint8_t*)conv, (const int*)iters, (const uint8_t*)valid,
                      (const int*)col_ptr, (const int*)col_idx,
                      (const unsigned long long*)lmask, (unsigned long long*)out,
                      batch, n_vars, m, n, T, distance, bp_only, overflow};
    const size_t smem = smem_bytes(m, n, warps);
    if (warps == 1)
        return (int)(unroll == 1 ? launch<1, 1>(a, sm_count, smem, stream)
                                 : launch<1, 4>(a, sm_count, smem, stream));
    return (int)launch<K9_THREADS / 32, 4>(a, sm_count, smem, stream);
}
