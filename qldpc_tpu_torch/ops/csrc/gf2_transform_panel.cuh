// The panel steps shared by the transform eliminations K4 (T in shared
// memory, gf2_transform_elim.cu) and K4g (T in global memory,
// gf2_transform_elim_global.cu): the cp.async staging of a panel's packed
// columns and the one-warp elimination of a panel's 32 columns on one word
// per row (gf2_transform_elim.cu's header says how). Neither touches T.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_util.cuh"

#define PANEL 32
#define FULL 0xffffffffu

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
