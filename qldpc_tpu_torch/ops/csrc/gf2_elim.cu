// Batched GF(2) reduced row echelon form of systems [A | b] (K2).
//
// Replaces qldpc_tpu/ops/osd_pallas.py::_elim_kernel, with the same result as
// the lanes elimination of qldpc_tpu/decoders/osd.py::_eliminate_lanes: for
// each column in order, the first row *position* at or below the current
// rank holding the column's bit becomes the pivot, is swapped into position
// `rank`, and is XORed into every other row holding the bit (rows above the
// rank included, so the result is a full RREF). piv_col[rank] = column.
//
// What bounds it on the card: instruction issue. Each sample is a dependent
// chain of up to n column steps (144 at [[144,12,12]], until rank 66) with
// little arithmetic in each; device memory is touched once to load and once
// to store. The design keeps a step to a few dozen warp instructions, with
// no shared memory and no barrier in the register instance:
//   * no rows move. Physical rows stay where they were loaded; a table of
//     each physical row's position (lane l holds rows l, l + 32, ..., as
//     pos << 16 | row) stands for the swaps. The pivot is the least key
//     pos << 16 | row over the rows holding the bit at a position >= rank:
//     one __reduce_min_sync. The swap exchanges two positions in the table;
//   * the register instance works column-major: lane l owns columns l,
//     l + 32, ..., each ceil(m / 32) words over the physical rows, in
//     registers (5 columns x 3 words at [[144]], 9 x 5 at [[288]]). Column
//     j comes to every lane by __shfl_sync; with p the pivot row, the mask
//     M = col_j ^ e_p goes into every owned column holding bit p, and into
//     b (a column every lane holds) if b holds it. A column before j never
//     changes again (a pivot column is a unit vector on a pivoted row, a
//     column without a pivot is zero on every unpivoted row), so a step
//     updates only the column slots from j's on;
//   * the shared instance, for the larger narrow systems, keeps the rows in
//     shared memory at an odd word stride (column-major would not fit: 673 x
//     2,656 needs 58,432 words of columns against 55,859 of rows) with the
//     same table and pivot rule; each lane XORs the pivot row into its rows
//     holding the bit.
// Rows are written back in position order. A sample stops once its rank
// reaches max_rank (rank(H) for OSD, where every later column step is a
// no-op). Two loaders: packed rows (transposed into columns by a 32 x 32
// warp bit transpose) with A written back, or H's packed columns read in
// each sample's column order, with b and piv_col alone written: the OSD
// decoder's path, which needs no permuted copy of H. The TPU kernel's
// one-hot masked reductions existed only because Mosaic could not index
// dynamically.
//
// Words are uint32 bit patterns carried in int32 tensors; column j of a row
// is bit j % 32 of word j / 32, row r of a column bit r % 32 of word r / 32.
// b holds 0/1.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "warp_util.cuh"

#define FULL 0xffffffffu
#define NONE 0xffffffffu  // no candidate row
#define REG_WARPS 8       // register instance: samples a block
#define SMEM_WARPS 8      // shared instance: samples a block at most
#define SMEM_MAX 232448

// Register instance: MW words a column (m <= 32 MW), NC columns a lane
// (n <= 32 NC and nw <= NC). ORDERED: columns from Hc (n, mwh) in the order
// order[s]; else from the packed rows A (B, m, nw), written back in place.
// Up to 15 words a lane, registers are bounded for five blocks an SM: the
// [[144]] code's 4,583 failures at p = 0.050119 in one wave.
template <int MW, int NC, bool ORDERED>
__global__ void __launch_bounds__(32 * REG_WARPS, MW * NC <= 15 ? 5 : 2) gf2_elim_reg_kernel(
    uint32_t* __restrict__ A, const int* __restrict__ order,
    const uint32_t* __restrict__ Hc, const int* __restrict__ b_in,
    int* __restrict__ b_out, int* __restrict__ piv,
    int B, int m, int nw, int n, int mwh, int max_rank)
{
    const int lane = threadIdx.x & 31;
    const int s = blockIdx.x * REG_WARPS + (threadIdx.x >> 5);
    if (s >= B) return;  // whole warp: nothing below waits on the others

    uint32_t c[NC][MW];  // lane's columns l + 32 t, word g: rows 32 g ...
    if constexpr (ORDERED) {
        const int* o = order + (size_t)s * n;
        unrolled<NC>([&](auto t) {
            const int k = 32 * t + lane;
            const uint32_t* col = k < n ? Hc + (size_t)o[k] * mwh : nullptr;
            unrolled<MW>([&](auto g) { c[t][g] = col && g < mwh ? col[g] : 0u; });
        });
    } else {
        const uint32_t* rows = A + (size_t)s * m * nw;
        unrolled<NC>([&](auto t) {
            unrolled<MW>([&](auto g) {
                const int r = 32 * g + lane;
                c[t][g] = transpose32(r < m && t < nw ? rows[(size_t)r * nw + t] : 0u, lane);
            });
        });
    }
    uint32_t bv[MW], key[MW];  // b over the rows (every lane); rows 32 g + l
    unrolled<MW>([&](auto g) {
        const int r = 32 * g + lane;
        bv[g] = __ballot_sync(FULL, r < m && (b_in[(size_t)s * m + r] & 1));
        key[g] = ((uint32_t)r << 16) | (uint32_t)r;
    });

    int* piv_s = piv + (size_t)s * m;
    int rank = 0;
    // column j, every lane's copy: shuffled from its owner one step ahead,
    // then brought up to date with the step before it, so that no shuffle
    // waits on the last step's update
    uint32_t col[MW];
    unrolled<MW>([&](auto g) { col[g] = __shfl_sync(FULL, c[0][g], 0); });
    unrolled<NC>([&](auto T) {
        for (int i = 0; i < 32; ++i) {
            const int j = 32 * T + i;
            if (j >= n || rank >= max_rank) break;  // warp-uniform
            uint32_t nxt[MW];  // column j + 1 as its owner holds it before this step
            unrolled<MW>([&](auto g) {
                uint32_t v = c[T][g];
                if constexpr (decltype(T)::value + 1 < NC) {
                    if (i == 31) v = c[T + 1][g];
                }
                nxt[g] = __shfl_sync(FULL, v, (i + 1) & 31);
            });
            // the pivot: the least position >= rank among the rows holding bit j
            const uint32_t at = (uint32_t)rank << 16;
            uint32_t best = NONE;
            unrolled<MW>([&](auto g) {
                if (((col[g] >> lane) & 1u) && key[g] >= at) best = min(best, key[g]);
            });
            best = __reduce_min_sync(FULL, best);
            if (best == NONE) {
                unrolled<MW>([&](auto g) { col[g] = nxt[g]; });
                continue;
            }
            const uint32_t ppos = best >> 16, p = best & 0xffffu;
            if (ppos != (uint32_t)rank) {  // positions ppos and rank trade rows
                const uint32_t flip = (ppos ^ (uint32_t)rank) << 16;
                unrolled<MW>([&](auto g) {
                    const uint32_t pos = key[g] >> 16;
                    if (pos == ppos || pos == (uint32_t)rank) key[g] ^= flip;
                });
            }
            uint32_t e[MW], M[MW];  // e_p and the rows column j eliminates
            unrolled<MW>([&](auto g) {
                e[g] = (int)g == (int)(p >> 5) ? 1u << (p & 31) : 0u;
                M[g] = col[g] ^ e[g];
            });
            unrolled<NC>([&](auto t) {
                if constexpr (decltype(t)::value >= decltype(T)::value) {
                    uint32_t hit = 0u;
                    unrolled<MW>([&](auto g) { hit |= c[t][g] & e[g]; });
                    if (hit) unrolled<MW>([&](auto g) { c[t][g] ^= M[g]; });
                }
            });
            uint32_t bp = 0u, np = 0u;
            unrolled<MW>([&](auto g) {
                bp |= bv[g] & e[g];
                np |= nxt[g] & e[g];
            });
            unrolled<MW>([&](auto g) {
                if (bp) bv[g] ^= M[g];
                col[g] = np ? nxt[g] ^ M[g] : nxt[g];
            });
            if (lane == 0) piv_s[rank] = j;
            ++rank;
        }
    });

    for (int pos = rank + lane; pos < m; pos += 32) piv_s[pos] = -1;
    unrolled<MW>([&](auto g) {
        const int r = 32 * g + lane;
        if (r < m) b_out[(size_t)s * m + (key[g] >> 16)] = (bv[g] >> lane) & 1u;
    });
    if constexpr (!ORDERED) {
        uint32_t* rows = A + (size_t)s * m * nw;
        unrolled<MW>([&](auto g) {
            const int r = 32 * g + lane;
            const size_t at = (size_t)(key[g] >> 16) * nw;
            unrolled<NC>([&](auto t) {
                const uint32_t x = transpose32(c[t][g], lane);  // lane l: row r's word t
                if (r < m && t < nw) rows[at + t] = x;
            });
        });
    }
}

// Shared instance: one warp a sample, its rows in shared memory at an odd
// word stride rs, with the row <-> position tables. Layout a warp: rows (m
// x rs words), b (mw words), the pivot column's word of each row group (mw
// words), position of each row and row at each position (m uint16 each).
__global__ void gf2_elim_smem_kernel(
    uint32_t* __restrict__ A, const int* __restrict__ order,
    const uint32_t* __restrict__ Hc, const int* __restrict__ b_in,
    int* __restrict__ b_out, int* __restrict__ piv,
    int B, int m, int nw, int n, int mwh, int max_rank, int rs, int per_warp, int ordered)
{
    extern __shared__ __align__(16) uint32_t smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int s = blockIdx.x * (blockDim.x >> 5) + warp;
    if (s >= B) return;  // whole warp
    const int mw = (m + 31) >> 5;
    uint32_t* sA = smem + (size_t)warp * per_warp;
    uint32_t* sB = sA + (size_t)m * rs;
    uint32_t* sC = sB + mw;
    uint16_t* pos_of = reinterpret_cast<uint16_t*>(sC + mw);
    uint16_t* row_at = pos_of + m;

    if (ordered) {
        // H's columns in this sample's order, transposed into rows
        const int* o = order + (size_t)s * n;
        for (int t = 0; t < nw; ++t) {
            const int k = 32 * t + lane;
            const uint32_t* col = k < n ? Hc + (size_t)o[k] * mwh : nullptr;
            for (int g = 0; g < mw; ++g) {
                const uint32_t x = transpose32(col && g < mwh ? col[g] : 0u, lane);
                if (32 * g + lane < m) sA[(size_t)(32 * g + lane) * rs + t] = x;
            }
        }
    } else {
        const uint32_t* gA = A + (size_t)s * m * nw;
        for (int i = lane; i < m * nw; i += 32) {
            const int r = i / nw;
            sA[(size_t)r * rs + (i - r * nw)] = gA[i];
        }
    }
    for (int g = 0; g < mw; ++g) {
        const int r = 32 * g + lane;
        const uint32_t bits = __ballot_sync(FULL, r < m && (b_in[(size_t)s * m + r] & 1));
        if (lane == 0) sB[g] = bits;
        if (r < m) {
            pos_of[r] = (uint16_t)r;
            row_at[r] = (uint16_t)r;
        }
    }
    __syncwarp();

    int* piv_s = piv + (size_t)s * m;
    int rank = 0;
    for (int j = 0; j < n && rank < max_rank; ++j) {
        const int w = j >> 5;
        const uint32_t bit = 1u << (j & 31);
        const uint32_t at = (uint32_t)rank << 16;
        uint32_t best = NONE;
        for (int g = 0; g < mw; ++g) {
            const int r = 32 * g + lane;
            const bool has = r < m && (sA[(size_t)r * rs + w] & bit);
            if (has) {
                const uint32_t k = ((uint32_t)pos_of[r] << 16) | (uint32_t)r;
                if (k >= at) best = min(best, k);
            }
            const uint32_t bal = __ballot_sync(FULL, has);
            if (lane == 0) sC[g] = bal;
        }
        best = __reduce_min_sync(FULL, best);
        if (best == NONE) continue;  // warp-uniform
        const int ppos = best >> 16, p = best & 0xffff;
        __syncwarp();  // sC and every read of the tables before the swap
        if (lane == 0) {
            const int q = row_at[rank];
            row_at[ppos] = (uint16_t)q;
            pos_of[q] = (uint16_t)ppos;
            row_at[rank] = (uint16_t)p;
            pos_of[p] = (uint16_t)rank;
            piv_s[rank] = j;
        }
        const uint32_t pw = p >> 5, pbit = 1u << (p & 31);
        const bool bp = sB[pw] & pbit;
        const uint32_t* prow = sA + (size_t)p * rs;
        for (int g = 0; g < mw; ++g) {
            const uint32_t mask = sC[g] & ~(g == (int)pw ? pbit : 0u);
            if ((mask >> lane) & 1u) {
                uint32_t* row = sA + (size_t)(32 * g + lane) * rs;
                for (int k = 0; k < nw; ++k) row[k] ^= prow[k];
            }
        }
        __syncwarp();  // every lane's reads of sB before lane g's write
        if (bp)
            for (int g = lane; g < mw; g += 32) sB[g] ^= sC[g] & ~(g == (int)pw ? pbit : 0u);
        ++rank;
        __syncwarp();
    }

    for (int pos = rank + lane; pos < m; pos += 32) piv_s[pos] = -1;
    for (int pos = lane; pos < m; pos += 32) {
        const int r = row_at[pos];
        b_out[(size_t)s * m + pos] = (sB[r >> 5] >> (r & 31)) & 1u;
    }
    if (!ordered) {
        uint32_t* gA = A + (size_t)s * m * nw;
        for (int i = lane; i < m * nw; i += 32) {
            const int pos = i / nw;
            gA[i] = sA[(size_t)row_at[pos] * rs + (i - pos * nw)];
        }
    }
}

// The register instances, as (words a column, columns a lane); osd_cuda.py's
// REG_INSTANCES lists the same, and its launch_instance picks one from the
// shape (-1: the shared instance).
template <bool ORDERED>
static const void* reg_instance(int instance)
{
    switch (instance) {
    case 0: return (const void*)gf2_elim_reg_kernel<1, 1, ORDERED>;
    case 1: return (const void*)gf2_elim_reg_kernel<2, 4, ORDERED>;
    case 2: return (const void*)gf2_elim_reg_kernel<3, 5, ORDERED>;
    case 3: return (const void*)gf2_elim_reg_kernel<5, 9, ORDERED>;
    default: return nullptr;
    }
}

static int launch(bool ordered, int instance, void* A, const void* order, const void* Hc,
                  const void* b_in, void* b_out, void* piv, int B, int m, int nw, int n,
                  int mwh, int max_rank, void* stream)
{
    if (B <= 0 || m <= 0) return (int)cudaSuccess;
    if (m > 65535) return (int)cudaErrorInvalidValue;
    if (instance >= 0) {
        const void* kernel = ordered ? reg_instance<true>(instance) : reg_instance<false>(instance);
        if (!kernel) return (int)cudaErrorInvalidValue;
        void* args[] = {&A, (void*)&order, (void*)&Hc, (void*)&b_in, &b_out, &piv,
                        &B, &m, &nw, &n, &mwh, &max_rank};
        return (int)cudaLaunchKernel(kernel, dim3((B + REG_WARPS - 1) / REG_WARPS),
                                     dim3(32 * REG_WARPS), args, 0, (cudaStream_t)stream);
    }
    // a warp's rows at an odd stride, b and the pivot column's words, the
    // two uint16 tables of m entries
    const int mw = (m + 31) / 32;
    const size_t per_warp = (size_t)m * (nw | 1) + 2 * (size_t)mw + (size_t)m;
    if (per_warp * 4 > SMEM_MAX) return (int)cudaErrorInvalidValue;
    const int warps = (int)std::min<size_t>(SMEM_WARPS, SMEM_MAX / 4 / per_warp);
    const size_t smem = per_warp * 4 * warps;
    cudaError_t err = cudaFuncSetAttribute(
        gf2_elim_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int rs = nw | 1, pw = (int)per_warp, ord = ordered;
    void* args[] = {&A, (void*)&order, (void*)&Hc, (void*)&b_in, &b_out, &piv,
                    &B, &m, &nw, &n, &mwh, &max_rank, &rs, &pw, &ord};
    return (int)cudaLaunchKernel((const void*)gf2_elim_smem_kernel, dim3((B + warps - 1) / warps),
                                 dim3(32 * warps), args, smem, (cudaStream_t)stream);
}

// Packed rows A (B, m, nw) reduced in place into position order, b (B, m)
// into b_out, piv (B, m).
extern "C" int gf2_elim_rows_launch(
    void* A, const void* b, void* b_out, void* piv, int B, int m, int nw, int n, int max_rank,
    int instance, void* stream)
{
    return launch(false, instance, A, nullptr, nullptr, b, b_out, piv, B, m, nw, n, 0, max_rank,
                  stream);
}

// H's packed columns Hc (., mwh) read as column order[s][k] for column k < n
// of sample s; b (B, m) in, b_out and piv (B, m) out.
extern "C" int gf2_elim_ordered_launch(
    const void* order, const void* Hc, const void* b, void* b_out, void* piv,
    int B, int m, int n, int mwh, int max_rank, int instance, void* stream)
{
    return launch(true, instance, nullptr, order, Hc, b, b_out, piv, B, m, (n + 31) / 32, n, mwh,
                  max_rank, stream);
}
