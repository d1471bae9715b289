// Structured space-time belief propagation (K6).
//
// Replaces qldpc_tpu/ops/spacetime_bp_pallas.py::_st_bp_kernel. It computes
// flooding BP on H_st = [I_T (x) H | I + S_{-m}] without building it, as
// qldpc_tpu/decoders/spacetime_bp.py::SpaceTimeBPDecoder._build does, in
// the same floating-point order, so the plain torch version in
// ops/spacetime_bp_cuda.py is its exact reference. The TPU kernel moved the
// spatial messages of each round with one-hot MXU matmuls on the base
// tables and evaluated atanh through its log identity; here every thread
// gathers from shared memory and calls atanhf.
//
// What bounds it on the card: latency. Device memory is touched only to
// load a sample's detectors and the priors and to store its posteriors; Q
// and R on all T*m*(dc + 2) slots, the T*(n + m) posteriors and the hard
// decisions stay in shared memory (69 KB a sample at [[144,12,12]], T = 12).
// A batch's time is that of its slowest samples (at p = 0.008 one in twenty
// runs all 100 iterations), so what counts is how long one iteration of one
// sample takes: dependent tanhf -> prefix/suffix -> atanhf chains and the
// barriers between the phases, which a single block of a few warps cannot
// hide. So a sample's T rounds are split over a cluster of C blocks on
// neighbouring multiprocessors, each holding a contiguous range of rounds
// in its own shared memory with a thread per variable of its rounds. The
// rounds couple only through the measurement variables: u_t meets check t
// and check t+1. So each iteration a block sends m floats to each
// neighbour through distributed shared memory: the R of its first round's
// u_{t-1} slots to the block before it, and the posterior of its last
// round's u_t to the block after it, which updates that Q itself. Two
// cluster barriers an iteration order those exchanges; the convergence test
// is one OR of per-warp mismatch masks into every block's flag word, read
// after the next iteration's first barrier (the check phase it overlaps
// writes only R, which a converged sample never reads again). Where a whole
// sample is small, C = 1 and a block decodes several samples.
//
// Layout per block and sample, over its Tl rounds: spatial slot
// tl*E + c*dc + j (E = m*dc, the base code's edge e = c*dc + j in round
// t0 + tl); temporal slots tl*m + c, "a" for u_t and "b" for u_{t-1}, whose
// round-0 entries are the phantom pinned to BIG. The priors are per
// variable, shared by the batch, and read through the cache. Per iteration:
//   1. check phase, one thread per (sample, round, check): first, in the
//      first round of a block after the first, Q_b from the posterior of
//      u_{t-1} the block before sent (the previous iteration's update of
//      that message, deferred to here); then R on the dc + 2 slots from Q,
//      the rule of K1;
//   -- cluster barrier; samples whose detectors the previous iteration
//      reproduced are frozen, and the loop ends when none is left --
//   2. variable phase, one thread per (sample, round, variable): the
//      posterior as a left fold over the base variable's edges in that round
//      plus the prior, hard decision, Q = posterior - R on its edges; then
//      one thread per (sample, round, check) for u_t: the posterior
//      (R_a[t] + R_b[t+1]) + prior (R_b[T] = 0), Q_a[t] and Q_b[t+1];
//      damping and clip on all three message planes;
//   -- cluster barrier --
//   3. syndrome phase, one thread per (sample, round, check): parity of the
//      base check's hard decisions in round t, u_t and u_{t-1} against the
//      detector, a warp's mismatches ORed into every block's flag word.
// Every message takes the same floating-point operations in the same order
// whatever C is: only where a value lives depends on it.
// A converged sample keeps the state of the iteration that converged it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define MAX_SLOTS 32
#define MAX_S 16
#define MAX_CLUSTER 8
#define MAX_THREADS 512
#define TANH_CLIP 0.9999999f

// torch.clamp and torch.min propagate NaN, fminf and fmaxf drop it (as K1)
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi)
{
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float max_nan(float x, float lo)
{
    return isnan(x) ? x : fmaxf(x, lo);
}

// R on k slots of one check from q[0..k-1]; writes r[j] for each slot.
__device__ __forceinline__ void check_rule(
    const float* q, float* r, int k, float ss, int method,
    float alpha, int use_alpha, float offset, int use_offset)
{
    if (method == 0) {
        // leave-one-out product as exclusive prefix x exclusive suffix,
        // both folded sequentially (bp.py::_others_product)
        float t[MAX_SLOTS], suf[MAX_SLOTS];
        for (int j = 0; j < k; ++j) t[j] = tanhf(q[j] * 0.5f);
        suf[k - 1] = t[k - 1];
        for (int j = k - 2; j >= 0; --j) suf[j] = suf[j + 1] * t[j];
        float left = 1.0f;
        for (int j = 0; j < k; ++j) {
            const float right = j + 1 < k ? suf[j + 1] : 1.0f;
            float x = (left * right) * ss;
            x = clamp_nan(x, -TANH_CLIP, TANH_CLIP);
            float rr = 2.0f * atanhf(x);
            if (use_alpha) rr = rr * alpha;
            r[j] = rr;
            left = left * t[j];
        }
    } else {
        // min-sum: leave-one-out sign, two minima with the first argmin,
        // optional offset, then alpha; a NaN |Q| makes every magnitude NaN
        int neg = 0;
        float min1 = fabsf(q[0]);
        int amin = 0;
        bool has_nan = false;
        for (int j = 0; j < k; ++j) {
            neg += q[j] >= 0.0f ? 0 : 1;
            const float a = fabsf(q[j]);
            has_nan |= isnan(a);
            if (a < min1) { min1 = a; amin = j; }
        }
        if (has_nan) min1 = __int_as_float(0x7fffffff);
        float min2 = __int_as_float(0x7f800000);  // +inf
        for (int j = 0; j < k; ++j)
            if (j != amin) min2 = fminf(min2, fabsf(q[j]));
        for (int j = 0; j < k; ++j) {
            const int own = q[j] >= 0.0f ? 0 : 1;
            const float sign = ((neg - own) & 1) ? -1.0f : 1.0f;
            float mag = fabsf(q[j]) == min1 ? min2 : min1;
            if (use_offset) mag = max_nan(mag - offset, 0.0f);
            float rr = (ss * sign) * mag;
            if (use_alpha) rr = rr * alpha;
            r[j] = rr;
        }
    }
}

__device__ __forceinline__ float message_update(
    float qn, float q_old, float damp_new, float damp_old, int use_damping,
    float clip, int use_clip)
{
    if (use_damping) qn = damp_new * qn + damp_old * q_old;
    if (use_clip) qn = clamp_nan(qn, -clip, clip);
    return qn;
}

__device__ __forceinline__ void cluster_barrier(int C)
{
    if (C > 1) cg::this_cluster().sync();
    else __syncthreads();
}

__global__ void __launch_bounds__(MAX_THREADS) st_bp_kernel(
    const uint8_t* __restrict__ syn,       // (B, T*m) 0/1 detectors
    const float* __restrict__ prior_sp,    // (T*n,)
    const float* __restrict__ prior_u,     // (T*m,)
    const int* __restrict__ check_var,     // (m, dc) base code
    const int* __restrict__ var_edge,      // (n, dv) base code, padded with E
    float* __restrict__ values_out,        // (B, T*n + T*m)
    uint8_t* __restrict__ conv_out,        // (B,)
    int* __restrict__ iters_out,           // (B,)
    int B, int T, int m, int n, int dc, int dv,
    int method, float alpha, int use_alpha, float offset, int use_offset,
    float damp_new, float damp_old, int use_damping,
    float clip, int use_clip, int max_iter, int S, int C)
{
    extern __shared__ float smem[];
    // this block's rounds [t0, t0 + Tl) of its cluster's S samples
    const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
    const int t0 = rank * T / C, Tl = (rank + 1) * T / C - t0;
    const int E = m * dc, TlE = Tl * E, Tlm = Tl * m, Tln = Tl * n;
    const int Tm = T * m, Tn = T * n;
    const int k = dc + 2;
    const bool first = t0 == 0, last = t0 + Tl == T;
    // the halos first: a neighbour finds them at the same offsets, whatever
    // its own Tl
    float* rb_next = smem;             // (S, m) R_b of round t0 + Tl, from the block after
    float* v_prev = rb_next + S * m;   // (S, m) posterior of u_{t0-1}, from the block before
    float* Qs = v_prev + S * m;     // (S, Tl*E)
    float* Qa = Qs + S * TlE;       // (S, Tl*m)
    float* Qb = Qa + S * Tlm;       // (S, Tl*m), round 0 pinned to BIG
    float* Rs = Qb + S * Tlm;       // (S, Tl*E)
    float* Ra = Rs + S * TlE;       // (S, Tl*m)
    float* Rb = Ra + S * Tlm;       // (S, Tl*m)
    float* Vs = Rb + S * Tlm;       // (S, Tl*n) data posteriors
    float* Vu = Vs + S * Tln;       // (S, Tl*m) measurement posteriors
    uint8_t* hs = reinterpret_cast<uint8_t*>(Vu + S * Tlm);  // (S, Tl*n)
    uint8_t* hu = hs + S * Tln;     // (S, Tl*m)
    uint8_t* ssyn = hu + S * Tlm;   // (S, Tl*m)

    // mismatch flags (bit s: sample s missed a detector), by iteration parity
    __shared__ uint32_t flags[2];
    __shared__ int iters_s[MAX_S];

    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int b0 = (blockIdx.x / C) * S;
    float* rb_next_before = rb_next;  // the block before's rb_next
    float* v_prev_after = v_prev;     // the block after's v_prev
    uint32_t* flags_of[MAX_CLUSTER];
    if (C > 1) {
        cg::cluster_group cluster = cg::this_cluster();
        if (!first) rb_next_before = cluster.map_shared_rank(rb_next, rank - 1);
        if (!last) v_prev_after = cluster.map_shared_rank(v_prev, rank + 1);
        for (int c = 0; c < C; ++c) flags_of[c] = cluster.map_shared_rank(flags, c);
    } else {
        flags_of[0] = flags;
    }

    for (int i = tid; i < S * Tln; i += nt) {
        const int r = i % Tln;
        Vs[i] = prior_sp[t0 * n + r];
    }
    for (int i = tid; i < S * Tlm; i += nt) {
        const int s = i / Tlm, r = i - s * Tlm, b = b0 + s;
        const int g = t0 * m + r;  // the check's row of H_st
        const float pu = prior_u[g];
        Vu[i] = pu;
        Qa[i] = pu;
        Qb[i] = g < m ? 1e9f : prior_u[g - m];
        ssyn[i] = b < B ? syn[(size_t)b * Tm + g] : 0;
    }
    for (int i = tid; i < S * TlE; i += nt) {
        const int r = i % TlE, tl = r / E, e = r - tl * E;
        Qs[i] = prior_sp[(t0 + tl) * n + check_var[e]];
    }
    if (tid < 2) flags[tid] = 0u;
    if (tid < S) iters_s[tid] = max_iter > 0 ? max_iter - 1 : 0;
    uint32_t active = 0u, conv = 0u;
    for (int s = 0; s < S; ++s)
        if (b0 + s < B) active |= 1u << s;
    // every block of the cluster runs, and its flags are zero, before any
    // block writes into another
    cluster_barrier(C);

    int it = 0;
    for (; it < max_iter; ++it) {
        if (tid == 0) flags[it & 1] = 0u;  // last read before the previous barrier
        // ---- 1. check phase ----------------------------------------------
        for (int i = tid; i < S * Tlm; i += nt) {
            const int s = i / Tlm, r = i - s * Tlm;
            if (!((active >> s) & 1u)) continue;
            const int tl = r / m, c = r - tl * m;
            if (tl == 0 && !first && it > 0)  // the last iteration's Q_b of u_{t0-1}
                Qb[i] = message_update(v_prev[s * m + c] - Rb[i], Qb[i], damp_new, damp_old,
                                       use_damping, clip, use_clip);
            float q[MAX_SLOTS], rr[MAX_SLOTS];
            const float* qs = Qs + (size_t)s * TlE + r * dc;
            for (int j = 0; j < dc; ++j) q[j] = qs[j];
            q[dc] = Qa[i];
            q[dc + 1] = Qb[i];
            check_rule(q, rr, k, ssyn[i] ? -1.0f : 1.0f, method,
                       alpha, use_alpha, offset, use_offset);
            float* rs = Rs + (size_t)s * TlE + r * dc;
            for (int j = 0; j < dc; ++j) rs[j] = rr[j];
            Ra[i] = rr[dc];
            Rb[i] = rr[dc + 1];
            if (tl == 0 && !first) rb_next_before[s * m + c] = rr[dc + 1];
        }
        cluster_barrier(C);
        if (it > 0) {
            // samples whose detectors the last iteration reproduced
            const uint32_t done = active & ~flags[(it - 1) & 1];
            if (tid < S && ((done >> tid) & 1u)) iters_s[tid] = it - 1;
            conv |= done;
            active &= ~done;
            if (!active) break;
        }

        // ---- 2. variable phase: data variables ---------------------------
        for (int i = tid; i < S * Tln; i += nt) {
            const int s = i / Tln, r = i - s * Tln;
            if (!((active >> s) & 1u)) continue;
            const int tl = r / n, v = r - tl * n;
            const int* ve = var_edge + v * dv;
            const float* rs = Rs + (size_t)s * TlE + tl * E;
            float acc = ve[0] < E ? rs[ve[0]] : 0.0f;
            for (int j = 1; j < dv; ++j) acc = acc + (ve[j] < E ? rs[ve[j]] : 0.0f);
            const float val = acc + prior_sp[t0 * n + r];
            Vs[i] = val;
            hs[i] = val < 0.0f;
            float* qs = Qs + (size_t)s * TlE + tl * E;
            for (int j = 0; j < dv; ++j) {
                const int e = ve[j];
                if (e >= E) continue;
                qs[e] = message_update(val - rs[e], qs[e], damp_new, damp_old,
                                       use_damping, clip, use_clip);
            }
        }
        // ---- 2'. variable phase: measurement variables (a shift) ---------
        for (int i = tid; i < S * Tlm; i += nt) {
            const int s = i / Tlm, r = i - s * Tlm;
            if (!((active >> s) & 1u)) continue;
            const int c = r % m;
            const bool top = r >= Tlm - m;  // this block's last round
            const bool final_round = top && last;
            const float ra = Ra[i];
            const float rb = final_round ? 0.0f : top ? rb_next[s * m + c] : Rb[i + m];
            const float val = (ra + rb) + prior_u[t0 * m + r];
            Vu[i] = val;
            hu[i] = val < 0.0f;
            Qa[i] = message_update(val - ra, Qa[i], damp_new, damp_old,
                                   use_damping, clip, use_clip);
            if (final_round) continue;
            if (top)
                v_prev_after[s * m + c] = val;
            else
                Qb[i + m] = message_update(val - rb, Qb[i + m], damp_new,
                                           damp_old, use_damping, clip, use_clip);
        }
        cluster_barrier(C);

        // ---- 3. syndrome phase -------------------------------------------
        uint32_t miss = 0u;
        for (int i = tid; i < S * Tlm; i += nt) {
            const int s = i / Tlm, r = i - s * Tlm;
            if (!((active >> s) & 1u)) continue;
            const int tl = r / m, c = r - tl * m;
            const int* cv = check_var + c * dc;
            const uint8_t* h = hs + (size_t)s * Tln + tl * n;
            int par = hu[i];
            if (tl > 0) par ^= hu[i - m];
            else if (!first) par ^= v_prev[s * m + c] < 0.0f;
            for (int j = 0; j < dc; ++j) par ^= h[cv[j]];
            if (par != ssyn[i]) miss |= 1u << s;
        }
        miss = __reduce_or_sync(0xffffffffu, miss);
        if ((tid & 31) == 0 && miss)
            for (int c = 0; c < C; ++c) atomicOr(flags_of[c] + (it & 1), miss);
    }
    if (it == max_iter && max_iter > 0) {
        cluster_barrier(C);
        conv |= active & ~flags[(it - 1) & 1];
    }
    __syncthreads();

    const int N = Tn + Tm;
    for (int i = tid; i < S * Tln; i += nt) {
        const int s = i / Tln, b = b0 + s;
        if (b < B) values_out[(size_t)b * N + t0 * n + (i - s * Tln)] = Vs[i];
    }
    for (int i = tid; i < S * Tlm; i += nt) {
        const int s = i / Tlm, b = b0 + s;
        if (b < B) values_out[(size_t)b * N + Tn + t0 * m + (i - s * Tlm)] = Vu[i];
    }
    if (rank == 0 && tid < S && b0 + tid < B) {
        conv_out[b0 + tid] = (uint8_t)((conv >> tid) & 1u);
        iters_out[b0 + tid] = iters_s[tid];
    }
}

// S samples a cluster of C blocks (C > 1 only with S = 1), Tl_max rounds a
// block at most
static size_t smem_bytes(int S, int Tl, int m, int n, int dc)
{
    const size_t Tlm = (size_t)Tl * m, Tln = (size_t)Tl * n, TlE = Tlm * dc;
    return (size_t)S * (2 * TlE + 5 * Tlm + Tln + 2 * (size_t)m) * sizeof(float)
           + (size_t)S * (Tln + 2 * Tlm);
}

extern "C" int st_bp_launch(
    const void* syn, const void* prior_sp, const void* prior_u,
    const void* check_var, const void* var_edge,
    void* values_out, void* conv_out, void* iters_out,
    int B, int T, int m, int n, int dc, int dv, int method,
    float alpha, int use_alpha, float offset, int use_offset,
    float damp_new, float damp_old, int use_damping,
    float clip, int use_clip, int max_iter,
    int samples_per_cluster, int cluster, int threads, void* stream)
{
    const int S = samples_per_cluster, C = cluster;
    if (dc + 2 > MAX_SLOTS || S > MAX_S || S < 1 || C < 1 || C > MAX_CLUSTER || C > T
        || (C > 1 && S > 1) || threads < 32 || threads > MAX_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(S, (T + C - 1) / C, m, n, dc);
    // opt in for every size: the static shared memory counts against the
    // same 48 KB default as the dynamic part
    cudaError_t err = cudaFuncSetAttribute(
        st_bp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int groups = (B + S - 1) / S;
    if (groups == 0) return (int)cudaSuccess;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(groups * C);
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = smem;
    config.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(
        &config, st_bp_kernel,
        (const uint8_t*)syn, (const float*)prior_sp, (const float*)prior_u,
        (const int*)check_var, (const int*)var_edge,
        (float*)values_out, (uint8_t*)conv_out, (int*)iters_out,
        B, T, m, n, dc, dv, method, alpha, use_alpha, offset, use_offset,
        damp_new, damp_old, use_damping, clip, use_clip, max_iter, S, C);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
