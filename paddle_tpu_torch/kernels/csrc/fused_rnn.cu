// Fused LSTM and GRU recurrences for Hopper (sm_90a), each with a
// float32 and a bfloat16 lane (the bf16 recurrences, B10/B11, B14/B15 and
// B12/B13, on the resident route below, their products on the tensor
// cores; the LSTM's fp32 recurrences on the grid route at D 256-768, their
// products on the tensor cores as 3xTF32; the other fp32 recurrences
// streaming W on the CUDA cores; the dW reductions' bf16 lane on the
// tensor cores):
//   LSTM (gates i|f|c~|o, w [D, 4D]):
//     lstm_fwd       (B10) replaces paddle_tpu/kernels/fused_rnn.py:
//                    _lstm_fwd_kernel, launched by _lstm_fwd_call;
//     lstm_bwd +     (B11) the reverse recurrence and the dW reduction
//     lstm_dw        of _lstm_bwd_kernel (_lstm_bwd_call);
//     lstm_proj_fwd  (B14) _lstm_proj_fwd_kernel (_lstm_proj_fwd_call):
//                    B10 with xe_t @ Wx + b computed inside the step;
//     lstm_proj_bwd  (B15) _lstm_proj_bwd_kernel (_lstm_proj_bwd_call):
//     (+ lstm_dw     the recurrence with dxe = dgates_lp @ Wx^T and the
//      over [Wx; W]) fp32 db, then dWx and dW in one reduction;
//     the bf16 lane on the resident route (rc:: below):
//     lstm_cluster_fwd_kernel and lstm_cluster_bwd_kernel, the two
//     recurrences, serve B10 (C entry cluster_lstm_fwd_x: x in bf16 as
//     the step's first term), B11's recurrence (cluster_lstm_bwd without
//     db), B14 (cluster_lstm_fwd: the fp32 xg of lstm_xg_kernel, xe @ Wx
//     + b for every step) and B15's recurrence (cluster_lstm_bwd with db,
//     then lstm_dxe_kernel, dx @ Wx^T for every step); those two passes
//     are one persistent wgmma GEMM fed by TMA (rc::proj_gemm, C entry
//     proj_gemm); past D 512 (D 768, 1024, 1280) the bf16 lane takes the
//     grid route (rc:: below): lstm_grid_fwd_kernel (C entries
//     grid_lstm_fwd, B14's recurrence on xg, and grid_lstm_fwd_x, B10)
//     and lstm_grid_bwd_kernel (grid_lstm_bwd: B15's recurrence with db,
//     B11's without), beside the same two passes; the fp32 lane takes the
//     grid route at D 256, 512 and 768 (lstm_grid_fwd_f32_kernel,
//     lstm_grid_bwd_f32_kernel: lane 0 of the same C entries, beside the
//     passes' fp32 lane, proj_f32_kernel: lane 0 of proj_gemm); the
//     streaming kernels (lstm_fwd_kernel, lstm_bwd_kernel) keep the fp32
//     lane and the bf16 shapes no W-resident route takes;
//   GRU (gates u|r|c~, w [D, 3D]):
//     gru_fwd        (B12) _gru_fwd_kernel (_gru_fwd_call);
//     gru_bwd +      (B13) the reverse recurrence and the dW reduction
//     gru_dw         of _gru_bwd_kernel (_gru_bwd_call);
//     the bf16 lane on the resident route (rc::gru_cluster_fwd_kernel,
//     rc::gru_cluster_bwd_kernel: the same C entries with a cluster's
//     tile of 16, 32 or 48 rows for bb); the streaming kernels
//     (gru_fwd_kernel, gru_bwd_kernel) keep the fp32 lane and the bf16
//     shapes the plan does not make resident.
// Layouts are the JAX ones, time-major and row-major:
//   x, gates [T, B, G]    pre-projected input gates (+ bias) / the saved
//                         post-activation gates; G = 4D (LSTM), 3D (GRU)
//   xe       [T, B, E]    B14/B15: the raw layer input; wx [E, 4D], b [4D]
//   w        [D, G]       recurrent weights
//   lens     [B] fp32     valid lengths: step t of row b is live iff t < lens
//   h0, c0, dh0, dc0 [B, D]
//   hs, cs, dhs, dcs [T, B, D]
//   dx       [T, B, G]    pre-activation gate gradients
// Every tensor of a call shares one dtype (the lane), except lens and
// B15's fp32 db.
//
// The math follows the Pallas bodies operation for operation: the carries
// (h, c; dh, dc) stay fp32; every product rounds its operands to W's
// dtype first and sums in fp32 (bf16 x bf16 is exact in fp32, so the
// bf16 lane differs from the plain version only in the order of the fp32
// sums); a masked step keeps the state (m*new + (1-m)*old). hprev is
// [h0; hs[:-1]] and the LSTM's cprev [c0; cs[:-1]], both read in place in
// the stored dtype (in the bf16 lane the backward's c~ = f*c_prev + i*g
// uses the rounded cell, as the Pallas kernel does).
//
// What bounds them here, and the design. At the seq2seq training shape
// (T 30, B 512, D 512, bf16) one forward does 2*T*B*D*3D = 24 GFLOP
// over 112 MB: the card's bound is the bytes (0.034 ms); at the LSTM
// flagship's (T 100, B 128, D 512, bf16) B10 does 27 GFLOP over 134 MB
// (0.040 ms). But W (1.5 MiB in bf16, 3 MiB in fp32) is re-read by every
// step of the recurrence, and it does not fit one SM's 227 KB of shared
// memory, so the TPU kernel's design (W resident in VMEM for all T
// steps) does not carry over to one block. Three routes:
//   - bf16: W split over one thread-block cluster's shared memory (the
//     resident route, rc:: below, notes there): a step is a product of
//     the tile's h with the CTA's resident columns on the tensor cores
//     and an exchange between the cluster's CTAs by DSMEM, so neither L2
//     nor the SMs' arithmetic sets it, but the exchange and its cluster
//     barriers. fp32 W (4 MiB at D 512: 256 KiB a CTA over 16 CTAs) does
//     not fit one cluster.
//   - bf16 past D 512, and the LSTM's fp32 lane at D 256-768, where W
//     outgrows one cluster (the LSTM's grid route, rc:: below, notes
//     there): W resident across a group of D / 256 (fp32: D / 128)
//     clusters of 16 CTAs that the card holds at once, the step's
//     exchange through L2 behind one group barrier a step.
//   - streaming, the other fp32 shapes (and bf16 shapes the plan does not
//     make resident): W read from L2 every step, as follows.
//   - gru_fwd / gru_bwd: one block of 256 threads per tile of BB batch
//     rows (BB in 1, 2, 4, 8, picked by the wrapper so the tiles fill the
//     card), walking all T steps inside the block (the Pallas grid's
//     "arbitrary" time axis). Batch rows never interact, so there is no
//     grid-wide barrier. The tile's carry and the per-step vectors live
//     in shared memory; W is read from global memory every step (L2
//     holds it), with 16-byte loads (fp32) / 8-byte loads (bf16) of four
//     neighbouring columns per thread. Every block reads all of W every
//     step, so the L2's read rate, not the SMs' arithmetic, sets a step.
//     Forward, per step: phase A, g_ur = x[:, :2D] + h_lp @ W[:, :2D]
//     (4 columns of 2D per thread), u and r, rh = r*h; phase B, c =
//     tanh(x_c + rh_lp @ W[:, 2D:]) (2 columns per thread), the blend,
//     hs[t] and gates[t].
//     Backward, per step in reverse: phase 0 (elementwise) du_pre, dc_pre;
//     phase 1, drh = dc_lp @ W_c^T, dr_pre; phase 2, dur_lp @ W_ur^T and
//     dh_prev. Both products read W transposed (a copy the wrapper makes
//     once per call) with the forward's pattern, 2 columns per thread.
//     Every product is one routine, cols_dot. At B 512 that is 128
//     blocks x 1.5 MiB of L2 reads a step in bf16: 2.4-2.7 ms a call,
//     which is why the bf16 lane went resident.
//   - the dW reductions (gru_dw; lstm_dw, which serves B11 and B15's
//     [dWx; dW]): dW cannot be a per-block accumulator here (3 MiB of
//     fp32), so it is a second kernel after the recurrence, one GEMM
//     with the T*B rows as its depth: dW = sum_n A[n]^T dx[n], A =
//     hprev (GRU c~ columns: bf16(r * hprev); B15: [xe | hprev]), dx the
//     gate gradients already in W's dtype (the operands the Pallas
//     kernel multiplies). What bounds it is operations: B11 is 2 * 12800
//     * 512 * 2048 = 26.8 GFLOP over 68 MB, 0.027 ms at the bf16 tensor
//     cores' 989 TFLOP/s and 0.40 ms at the CUDA cores' 67 (fp32); but
//     with 128 x 256 output tiles the blocks read 320 MB from L2 into
//     shared memory, 12 TB/s at that pace, more than the L2 gives, so
//     the bytes moved into the SMs set it. The bf16 lane runs on the tensor
//     cores: two consumer warpgroups of wgmma m64n256k16 (m64n128k16 for
//     a GRU whose 2D is no multiple of 256) read both operands MN-major
//     from a ring of 64-row stages that one producer warp fills by TMA,
//     with mbarriers between them; fp32 accumulators stay in registers.
//     Blocks of a cluster along M share dx: each loads half of a stage's
//     dx and multicasts it to both, which halves dx's L2 reads (where the
//     card holds the grid's pairs in one wave). A comes
//     from xe, h0 or hs per 64 output rows and stage (the one stage that
//     straddles the hprev seam at row B takes its hprev rows by cp.async);
//     the GRU's c~ operand is formed in shared memory once its stage
//     lands. The fp32 lane stays on the CUDA cores (TF32 would miss the
//     fp32 gates): 128 x 128 tiles, 8 x 8 outputs a thread, double-
//     buffered cp.async stages. Both split the rows into fixed ranges
//     (the wrapper's dw_plan: the most splits that keep one wave of
//     blocks) whose fp32 partials a second pass sums in split order. No
//     atomics: the same inputs give the same bits.
// The LSTM's W is 2 MiB in bf16 (B14/B15 add Wx, 0.5 or 2 MiB), so the
// streaming kernels' steps are set by the same L2 reads: 128 blocks x
// 2-4 MiB a step (B10/B11 and B14/B15 in fp32, and in bf16 where neither
// W-resident route fits).
//
// The bf16 resident route (the LSTM's B10/B11 and B14/B15; the GRU's
// B12/B13 on the same helpers, differences below). What is left of
// a step once the input projection leaves it (xe @ Wx + b does not depend
// on h; dxe = dgates @ Wx^T does not feed the recurrence; B10/B11's x
// holds the projected gates already) is [B, D] x [D, 4D]: 2.1 MFLOP
// per 16 batch rows, far too little to hide L2 streaming of W. So W stays
// on chip: one thread-block cluster of D / 32 CTAs per tile of 16 or 32
// batch rows (16 CTAs at D 512: 16 x 227 KB holds W's 2 MiB, [Wx; W]'s 4
// would not fit), CTA j keeping the 128 gate columns of hidden units
// 32j..32j+31 (128 KiB at D 512) in shared memory for all T steps.
// Per step a CTA needs the whole h (forward) or contributes a partial
// to every unit's dh (reverse), so the CTAs of a cluster exchange h's
// bf16 slices (an all-gather) or dh's fp32 partials (a reduce-scatter)
// through distributed shared memory, with the hardware cluster barrier
// (arrive after the stores, wait before the reads) ordering each step;
// nothing crosses clusters, so clusters never wait on each other and
// the tiles beyond what the card holds at once run in waves. The
// products run on mma.sync m16n8k16 (bf16 in, fp32 sums) from the
// resident slice: the forward reads it as B [k][n] by ldmatrix, the
// reverse reads the same bytes transposed by ldmatrix.trans, so no
// transposed copy of W is made. The input projection runs before the
// loop as one GEMM (lstm_xg_kernel, fp32 out: the Pallas sum (xe Wx +
// b) + h W keeps its first term unrounded, and a bf16 xg would move
// 12-30 % of the gates by an ulp), and dxe after it from the rounded
// dgates (lstm_dxe_kernel: the same GEMM with Wx read transposed); both
// are rc::proj_gemm, persistent clusters of two on wgmma, the operands
// by TMA as they lie, the output staged and stored by TMA.
// B10 and B11's recurrence run the same two kernels: B10's step reads
// its first term from x in bf16 (widened to fp32, exact, so B10 on x is
// B14's recurrence on xg = float(x) bit for bit), and B11's reverse is
// B15's without db (no partials, no second launch).
// What bounds a step is the exchange, not the product: on an H100 (700
// W) a 16-CTA cluster barrier costs 0.7 us, and distributed shared
// memory moved 10-20 B a cycle into each SM, which the destinations'
// order, rotated by the sender's rank so that every receiver is busy at
// once, took from 3.3 to 2.2 us (forward, 30 KiB a CTA) and from 8.9 to
// 6.3 us (reverse, 60 KiB of fp32 partials and two barriers) a step.
// The card holds 7 such clusters at once, so at B 128 the plan takes 4
// tiles of 32 rows, not 8 of 16. Sums run in fixed orders (the K halves
// in the forward, the slots in rank order and db's partials in row-group
// and tile order in the reverse): two launches give the same bits.
// The GRU (rc::gru_cluster_fwd_kernel, rc::gru_cluster_bwd_kernel): CTA j
// keeps the 96 columns u | r | c~ of its units (99,840 B at D 512). Its
// reset comes before the candidate's product, c~ = tanh(x_c + bf16(r *
// h) W_c) (why no cuDNN GRU computes it), so each step has two products
// and two exchanges: the forward all-gathers bf16(r * h) after g_ur =
// x_ur + h W_ur and h after c~ (one h and one rh buffer: each CTA
// arrives after its last read of a buffer, and no CTA writes one before
// the barrier that follows every CTA's reads); the reverse
// reduce-scatters drh = dc~ W_c^T, then dur W_ur^T, through one set of
// fp32 slots (four barrier phases a step), both products reading the
// resident slice by ldmatrix.trans. The plan takes the tile (16, 32 or
// 48 rows) with the fewest waves: at the seq2seq batch (B 512) 11
// clusters of 48 rows in 2 waves, where 32 rows take 16 in 3. Every
// fp32 operation of the cell math is an __f*_rn intrinsic, so nothing is
// contracted into an FMA differently in another instantiation: a row's
// bits do not depend on its tile or on B.
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; each C entry returns cudaGetLastError().

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma_cp_async.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kFwdArrays = 4;   // [BB][D] fp32 arrays in the forward's smem
constexpr int kBwdArrays = 10;  // ... and in the backward's

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as .astype
}

// v rounded to T's precision, kept as fp32 (the Pallas `.astype(w.dtype)`
// before a product)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float2 bf2_to_f2(unsigned bits) {
  __nv_bfloat162 h;
  *reinterpret_cast<unsigned*>(&h) = bits;
  return __bfloat1622float2(h);
}

__device__ __forceinline__ unsigned f2_to_bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// four / two neighbouring elements as fp32 (16- / 8-byte aligned for fp32,
// 8- / 4-byte for bf16)
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const bf16* p, float* v) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = bf2_to_f2(q.x), b = bf2_to_f2(q.y);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void load2(const float* p, float* v) {
  const float2 q = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void load2(const bf16* p, float* v) {
  const float2 a = bf2_to_f2(__ldg(reinterpret_cast<const unsigned*>(p)));
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(f2_to_bf2(v[0], v[1]), f2_to_bf2(v[2], v[3]));
}
__device__ __forceinline__ void store2(float* p, const float* v) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store2(bf16* p, const float* v) {
  *reinterpret_cast<unsigned*>(p) = f2_to_bf2(v[0], v[1]);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// acc[b][c] = sum_{j < n} vec[b * ld_v + j] * m[j * ld_m + c], c < V: V
// neighbouring columns of a row-major matrix (m points at row 0 of this
// thread's first column) against each batch row's vector in shared memory.
// The rows of m are read from global memory four at a time (they stay in
// L2), the vectors as float4 broadcasts; the fp32 sum runs over j in order.
template <typename T, int BB, int V>
__device__ __forceinline__ void cols_dot(const T* __restrict__ m, int ld_m,
                                         const float* vec, int ld_v, int n,
                                         float (&acc)[BB][V]) {
#pragma unroll
  for (int b = 0; b < BB; ++b)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[b][c] = 0.f;
#pragma unroll 2
  for (int j = 0; j < n; j += 4) {
    float wv[4][V];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const T* row = m + static_cast<size_t>(j + jj) * ld_m;
      if constexpr (V == 4) {
        load4(row, wv[jj]);
      } else {
        load2(row, wv[jj]);
      }
    }
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const float4 v = *reinterpret_cast<const float4*>(vec + b * ld_v + j);
      const float vj[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < V; ++c)
          acc[b][c] = fmaf(vj[jj], wv[jj][c], acc[b][c]);
    }
  }
}

// ------------------------------------------------------------ forward (B12)

template <typename T, int BB>
__global__ void __launch_bounds__(kThreads)
    gru_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ lens, const T* __restrict__ h0,
                   T* __restrict__ hs, T* __restrict__ gates, int n_steps,
                   int B, int D) {
  extern __shared__ float smem[];
  float* h = smem;               // [BB][D] the fp32 carry
  float* h_lp = h + BB * D;      // [BB][D] h rounded to W's dtype
  float* u_s = h_lp + BB * D;    // [BB][D] update gate of this step
  float* rh_lp = u_s + BB * D;   // [BB][D] (r * h) rounded to W's dtype
  __shared__ float len_s[BB];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * BB;
  const int G = 3 * D;
  for (int i = tid; i < BB * D; i += kThreads) {
    const int b = i / D;
    const float v =
        b0 + b < B ? to_f(h0[static_cast<size_t>(b0 + b) * D + i % D]) : 0.f;
    h[i] = v;
    h_lp[i] = round_to<T>(v);
  }
  if (tid < BB) len_s[tid] = b0 + tid < B ? lens[b0 + tid] : 0.f;
  __syncthreads();

  for (int t = 0; t < n_steps; ++t) {
    const size_t row0 = static_cast<size_t>(t) * B + b0;  // (t, b0)
    // phase A: g_ur = x[:, :2D] + h_lp @ W[:, :2D]; u, r; rh = r * h
    for (int j0 = 4 * tid; j0 < 2 * D; j0 += 4 * kThreads) {
      float acc[BB][4];
      cols_dot<T, BB, 4>(w + j0, G, h_lp, D, D, acc);
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        if (b0 + b >= B) continue;
        float xv[4], s[4];
        load4(x + (row0 + b) * G + j0, xv);
#pragma unroll
        for (int c = 0; c < 4; ++c) s[c] = sigmoid(xv[c] + acc[b][c]);
        store4(gates + (row0 + b) * G + j0, s);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + c;  // a 4-group lies inside u or inside r
          if (j < D) {
            u_s[b * D + j] = s[c];
          } else {
            rh_lp[b * D + j - D] = round_to<T>(s[c] * h[b * D + j - D]);
          }
        }
      }
    }
    __syncthreads();
    // phase B: c = tanh(x_c + rh_lp @ W[:, 2D:]); h_t; the masked blend
    for (int j0 = 2 * tid; j0 < D; j0 += 2 * kThreads) {
      float acc[BB][2];
      cols_dot<T, BB, 2>(w + 2 * D + j0, G, rh_lp, D, D, acc);
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        if (b0 + b >= B) continue;
        const float m = static_cast<float>(t) < len_s[b] ? 1.f : 0.f;
        float xv[2], cv[2], hn[2];
        load2(x + (row0 + b) * G + 2 * D + j0, xv);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = b * D + j0 + c;
          cv[c] = tanhf(xv[c] + acc[b][c]);
          const float hp = h[i], u = u_s[i];
          const float ht = u * hp + (1.f - u) * cv[c];
          hn[c] = m * ht + (1.f - m) * hp;
          h[i] = hn[c];
          h_lp[i] = round_to<T>(hn[c]);
        }
        store2(hs + (row0 + b) * D + j0, hn);
        store2(gates + (row0 + b) * G + 2 * D + j0, cv);
      }
    }
    __syncthreads();
  }
}

// --------------------------------------------- backward recurrence (B13)

// wt is W transposed, [3D, D] (made once per call by the wrapper), so the
// two products of a step read it with the forward's column pattern:
// drh = dc_lp @ W_c^T takes rows 2D.. of wt, dur_lp @ W_ur^T rows ..2D.
template <typename T, int BB>
__global__ void __launch_bounds__(kThreads)
    gru_bwd_kernel(const T* __restrict__ gates, const T* __restrict__ hs,
                   const T* __restrict__ wt, const float* __restrict__ lens,
                   const T* __restrict__ h0, const T* __restrict__ dhs,
                   T* __restrict__ dx, T* __restrict__ dh0, int n_steps,
                   int B, int D) {
  extern __shared__ float smem[];
  const int N = BB * D;
  float* dh = smem;              // [BB][D] the fp32 carry dh
  float* u_s = dh + N;           // [BB][D] u of this step
  float* r_s = u_s + N;          // [BB][D] r
  float* hp_s = r_s + N;         // [BB][D] h_prev
  float* dht_s = hp_s + N;       // [BB][D] dh_t = m * dH
  float* keep_s = dht_s + N;     // [BB][D] (1 - m) * dH
  float* drhr_s = keep_s + N;    // [BB][D] drh * r
  float* dc_lp = drhr_s + N;     // [BB][D] dc_pre rounded to W's dtype
  float* dur_lp = dc_lp + N;     // [BB][2D] du_pre | dr_pre, rounded
  __shared__ float len_s[BB];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * BB;
  const int G = 3 * D;
  for (int i = tid; i < N; i += kThreads) dh[i] = 0.f;
  if (tid < BB) len_s[tid] = b0 + tid < B ? lens[b0 + tid] : 0.f;
  __syncthreads();

  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t row0 = static_cast<size_t>(t) * B + b0;
    // phase 0: the elementwise gate gradients
    for (int i = tid; i < N; i += kThreads) {
      const int b = i / D, k = i % D;
      if (b0 + b >= B) {  // a padding row of the tile: contributes nothing
        u_s[i] = r_s[i] = hp_s[i] = dht_s[i] = keep_s[i] = dc_lp[i] = 0.f;
        dur_lp[b * 2 * D + k] = dur_lp[b * 2 * D + D + k] = 0.f;
        continue;
      }
      const size_t n = row0 + b;
      const float u = to_f(gates[n * G + k]);
      const float r = to_f(gates[n * G + D + k]);
      const float c = to_f(gates[n * G + 2 * D + k]);
      const float hp = to_f(t > 0 ? hs[(n - B) * D + k]
                                  : h0[static_cast<size_t>(b0 + b) * D + k]);
      const float m = static_cast<float>(t) < len_s[b] ? 1.f : 0.f;
      const float dH = to_f(dhs[n * D + k]) + dh[i];
      const float dht = m * dH;
      const float du = dht * (hp - c);
      const float du_pre = du * u * (1.f - u);
      const float dc = dht * (1.f - u);
      const float dc_pre = dc * (1.f - c * c);
      u_s[i] = u;
      r_s[i] = r;
      hp_s[i] = hp;
      dht_s[i] = dht;
      keep_s[i] = (1.f - m) * dH;
      dc_lp[i] = round_to<T>(dc_pre);
      dur_lp[b * 2 * D + k] = round_to<T>(du_pre);
      dx[n * G + k] = from_f<T>(du_pre);
      dx[n * G + 2 * D + k] = from_f<T>(dc_pre);
    }
    __syncthreads();
    // phase 1: drh = dc_lp @ W_c^T (2 columns of D per thread); dr_pre
    for (int k0 = 2 * tid; k0 < D; k0 += 2 * kThreads) {
      float acc[BB][2];
      cols_dot<T, BB, 2>(wt + static_cast<size_t>(2 * D) * D + k0, D, dc_lp,
                         D, D, acc);
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        if (b0 + b >= B) continue;
        float dr_pre[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = b * D + k0 + c;
          const float r = r_s[i];
          dr_pre[c] = acc[b][c] * hp_s[i] * r * (1.f - r);
          dur_lp[b * 2 * D + D + k0 + c] = round_to<T>(dr_pre[c]);
          drhr_s[i] = acc[b][c] * r;
        }
        store2(dx + (row0 + b) * G + D + k0, dr_pre);
      }
    }
    __syncthreads();
    // phase 2: dh_prev = dh_t*u + drh*r + dur_lp @ W_ur^T + (1-m)*dH
    for (int k0 = 2 * tid; k0 < D; k0 += 2 * kThreads) {
      float acc[BB][2];
      cols_dot<T, BB, 2>(wt + k0, D, dur_lp, 2 * D, 2 * D, acc);
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        if (b0 + b >= B) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = b * D + k0 + c;
          dh[i] = dht_s[i] * u_s[i] + drhr_s[i] + acc[b][c] + keep_s[i];
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < N; i += kThreads) {
    const int b = i / D;
    if (b0 + b < B) dh0[static_cast<size_t>(b0 + b) * D + i % D] =
        from_f<T>(dh[i]);
  }
}

// ------------------------------------------- dW reductions (B13, B11, B15)
//
// dW = sum over the T*B rows n of A[n]^T dx[n]: an [M, G] product whose
// depth is the T*B rows, with both operands MN-major (the depth is the
// slow axis of hs, xe, gates and dx). A[n] is hprev row n (hs[n - B], or
// h0[n] for n < B, read in place) in output rows m >= E, and (B15) xe[n]
// in rows m < E; the GRU's c~ columns (>= 2D) take bf16(r * hprev), the
// fp32 product rounded to W's dtype as the plain version rounds it.
// Products in W's dtype, sums in fp32. The rows are split into fixed
// ranges of whole kDwRows chunks (the last one shorter), blockIdx.z the
// split: with one split a block writes its tile in W's dtype, else fp32
// partials [splits][M][G] that a second pass sums in split order. No
// atomics: the same inputs give the same bits.

constexpr int kDwRows = 64;  // the split granularity, rows

// rows per split (a multiple of kDwRows); the wrapper's dw_plan computes
// the same, and picks splits so that none is empty
inline int dw_rows_per_split(int n_rows, int splits) {
  const int chunks = (n_rows + kDwRows * splits - 1) / (kDwRows * splits);
  return kDwRows * (chunks > 1 ? chunks : 1);
}

// One launch's operands: M = E + D output rows, G gate columns.
template <typename T>
struct DwOps {
  const T* xe;     // [T*B, E] (B15), else null
  const T* hs;     // [T*B, D]
  const T* h0;     // [B, D]
  const T* gates;  // the GRU's [T*B, 3D] (r: columns D..2D), else null
  const T* dx;     // [T*B, G], in W's dtype
  float* part;     // [splits][M][G] fp32 partials when splits > 1
  T* dw;           // [M][G]
  int n_rows, B, D, E, G, M, per, splits;
  int cluster;     // bf16 lane: blocks sharing dx (along M)

  // row n of the A operand over the 64 output rows from m (a multiple of
  // 64, so the slice lies wholly in xe or wholly in hprev)
  __device__ __forceinline__ const T* a_row(int n, int m) const {
    if (m < E) return xe + static_cast<size_t>(n) * E + m;
    return (n >= B ? hs + static_cast<size_t>(n - B) * D
                   : h0 + static_cast<size_t>(n) * D) + (m - E);
  }
  // row n of the GRU's r for the hidden units from m
  __device__ __forceinline__ const T* r_row(int n, int m) const {
    return gates + static_cast<size_t>(n) * 3 * D + D + m;
  }
  __device__ __forceinline__ const T* dx_row(int n, int col) const {
    return dx + static_cast<size_t>(n) * G + col;
  }
};

// ---- bf16: warpgroup products (wgmma) from a TMA-filled ring

namespace tc {

constexpr int kBM = 128;  // output rows a block: 2 warpgroups x 64
constexpr int kBudget = 192 * 1024;

// A stage holds the A operand (kBM / 64 slices), dx (BN / 64) and, for
// the GRU, r (kBM / 64), each slice kBK rows of 128 bytes in the 128-byte
// swizzle that TMA writes and wgmma reads MN-major operands in (16-byte
// piece p of row r at r * 128 + ((p ^ (r % 8)) * 16), slices 1024-byte
// aligned).
template <bool GRU, int BN>
struct Cfg {
  static constexpr int kBK = 64;            // T*B rows a stage
  static constexpr int kSlice = kBK * 128;  // bytes of one slice a stage
  // a split ends on a stage boundary, so a stage's boxes never reach into
  // the next split's rows (past n_rows the maps load zeros)
  static_assert(kDwRows % kBK == 0, "a split is whole stages");
  static constexpr int kSlices = 2 + BN / 64 + (GRU ? 2 : 0);
  static constexpr int kStageBytes = kSlices * kSlice;
  static constexpr int kStages = kBudget / kStageBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + align
};

// wgmma's shared-memory matrix descriptor: 128-byte swizzle; lbo the
// bytes between 64-element slices along M/N, sbo between 8-row groups
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | static_cast<uint64_t>(1)
                                                     << 62;
}

// d (64 x N, fp32, the wgmma accumulator layout; N = 256 or 128 from d's
// size) += A (64 x 16) * B (16 x N), bf16 in shared memory; TA / TB the
// transpose bits: 1 for an MN-major operand (the dW reductions read both
// so), 0 for a K-major one
// eight accumulator operands of a wgmma
#define DW_R8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
template <int TA = 1, int TB = 1>
__device__ __forceinline__ void mma(float (&d)[128], uint64_t a,
                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : DW_R8(0), DW_R8(8), DW_R8(16), DW_R8(24),
        DW_R8(32), DW_R8(40), DW_R8(48), DW_R8(56),
        DW_R8(64), DW_R8(72), DW_R8(80), DW_R8(88),
        DW_R8(96), DW_R8(104), DW_R8(112), DW_R8(120)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA = 1, int TB = 1>
__device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : DW_R8(0), DW_R8(8), DW_R8(16), DW_R8(24),
        DW_R8(32), DW_R8(40), DW_R8(48), DW_R8(56)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}
#undef DW_R8

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// bf16(r * h) for two packed pairs (fp32 product, round to nearest even)
__device__ __forceinline__ unsigned mul_bf2(unsigned h, unsigned r) {
  const float2 a = bf2_to_f2(h), b = bf2_to_f2(r);
  return f2_to_bf2(b.x * a.x, b.y * a.y);
}

// mbarriers, TMA and the thread block cluster. The arrives are relaxed:
// a release arrive would also wait for the arriving thread's own copies
// still in flight, and what it signals (the products on a stage are done,
// the bytes a stage expects) needs no ordering of earlier writes.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// arrive expecting `bytes`; `release` also publishes this thread's earlier
// writes (and those ordered before them) to the waiters
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes,
                                               bool release) {
  if (release) {
    asm volatile(
        "mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], "
        "%1;\n" ::"r"(bar),
        "r"(bytes)
        : "memory");
  } else {
    asm volatile(
        "mbarrier.arrive.expect_tx.relaxed.cta.shared::cta.b64 _, [%0], "
        "%1;\n" ::"r"(bar),
        "r"(bytes)
        : "memory");
  }
}
// arrive on the barrier at the same offset in the cluster's block `rank`
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, int rank) {
  asm volatile(
      "{\n.reg .b32 a;\nmapa.shared::cluster.u32 a, %0, %1;\n"
      "mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [a];\n}\n" ::
          "r"(bar),
      "r"(rank)
      : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}
__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the box at (x, y) of a 2-D tensor map to shared memory at dst,
// completing on bar; with cm > 1 multicast to the cluster's cm blocks
// (the same offsets there)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar,
                                         int cm = 1) {
  if (cm == 1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
        "l"(map), "r"(x), "r"(y), "r"(bar)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], "
        "%5;\n" ::"r"(dst),
        "l"(map), "r"(x), "r"(y), "r"(bar),
        "h"(static_cast<uint16_t>((1 << cm) - 1))
        : "memory");
  }
}

// the box at (x, y) of a 2-D tensor map from shared memory at src (a bulk
// group of this thread's); commit, and wait until at most N groups are
// still reading shared memory (.read) or writing device memory
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(map),
      "r"(src), "r"(x), "r"(y)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of wgmma accumulators above the
// wgmma.wait_group that completes them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The operands' tensor maps (64-column x kBK-row boxes, 128-byte swizzle):
// dx [n_rows, G]; hs [n_rows, D] (hprev row n >= B is hs row n - B); h0
// [B, D]; xe [n_rows, E] (B15); gates [n_rows, 3D] (the GRU's r: columns
// D..2D). Rows and columns past a map's bounds load as zeros.
struct DwMaps {
  CUtensorMap dx, hs, h0, xe, gates;
};

// One 128 x BN tile of dW over one split's rows: two consumer warpgroups
// (w owning output rows m0 + 64w..) and a producer warp, around a ring of
// kStages stages with a `full` and an `empty` barrier each. The producer
// fills a stage by TMA once every consumer of the cluster has released it:
// dx, shared by the cluster's blocks (1, cm, 1) (the same column tile and
// split), 1/cm of it from each block, multicast; A (xe, or hprev from h0 or
// hs) and the GRU's r for this block alone. A stage whose rows straddle
// the hprev seam at row B (B not a multiple of kBK) takes its hprev rows
// by cp.async instead, the warp's lanes choosing the source per row. The
// consumers wait for a stage, form the GRU's c~ operand bf16(r * hprev) in
// place, run their wgmmas and release the stage once they are done, so the
// producer keeps the other stages in flight.
template <bool GRU, int BN>
__global__ void __launch_bounds__(288, 1)
    dw_wgmma_kernel(const DwOps<bf16> op, const __grid_constant__ DwMaps maps) {
  using C = Cfg<GRU, BN>;
  constexpr int kBK = C::kBK, kSlice = C::kSlice, kS = C::kStages;
  constexpr int kR = 2 + BN / 64;  // the first r slice
  extern __shared__ uint8_t dw_smem[];
  __shared__ __align__(8) uint64_t bars[2 * kS];  // full, then empty
  const uint32_t raw = smem_u32(dw_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = dw_smem + (base - raw);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kS;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int j0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;
  const int n_begin = blockIdx.z * op.per;
  const int n_end = min(op.n_rows, n_begin + op.per);
  const int n_chunks = (n_end - n_begin + kBK - 1) / kBK;
  const bool cand = GRU && j0 >= 2 * op.D;  // c~ columns: A = r * hprev
  const int cm = op.cluster, rank = cluster_rank();
  const int n_a = min(2, (op.M - m0) / 64);  // A slices inside M

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * cm);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (wg == 2) {  // ---- the producer warp
    const int lane = tid & 31;
    const int dx_per = BN / 64 / cm;
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % kS;
      const uint32_t st = base + s * C::kStageBytes, full = full0 + 8 * s;
      const int n0 = n_begin + c * kBK;
      const bool seam = n0 < op.B && n0 + kBK > op.B;
      if (c >= kS) mbar_wait(empty0 + 8 * s, (c / kS - 1) & 1);
      if (seam) {  // hprev rows by cp.async, then make them visible
        for (int w = 0; w < n_a; ++w) {
          const int m = m0 + 64 * w;
          if (m < op.E) continue;
          for (int idx = lane; idx < kBK * 8; idx += 32) {
            const int p = idx & 7, r = idx >> 3, n = n0 + r;
            const bool ok = n < n_end;
            cp16(st + w * kSlice + r * 128 + ((p ^ (r & 7)) << 4),
                 ok ? op.a_row(n, m) + 8 * p : op.dx, ok);
          }
        }
        cp_commit();
        cp_wait<0>();
        fence_async();
        __syncwarp();
      }
      if (lane == 0) {
        int bytes = BN / 64 * kSlice;
        for (int w = 0; w < n_a; ++w) {
          const bool tma_a = m0 + 64 * w < op.E || !seam;
          bytes += (tma_a ? kSlice : 0) + (cand ? kSlice : 0);
        }
        mbar_expect_tx(full, bytes, seam);
        for (int j = rank * dx_per; j < (rank + 1) * dx_per; ++j) {
          tma_load(st + (2 + j) * kSlice, &maps.dx, j0 + 64 * j, n0, full,
                   cm);
        }
        for (int w = 0; w < n_a; ++w) {
          const int m = m0 + 64 * w;
          const uint32_t dst = st + w * kSlice;
          if (m < op.E) {
            tma_load(dst, &maps.xe, m, n0, full);
          } else if (!seam) {
            if (n0 >= op.B) {
              tma_load(dst, &maps.hs, m - op.E, n0 - op.B, full);
            } else {
              tma_load(dst, &maps.h0, m - op.E, n0, full);
            }
          }
          if (cand) tma_load(st + (kR + w) * kSlice, &maps.gates,
                             op.D + m, n0, full);
        }
      }
    }
  } else {  // ---- the consumer warpgroups
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % kS;
      const uint32_t st = base + s * C::kStageBytes;
      mbar_wait(full0 + 8 * s, (c / kS) & 1);
      if (cand) {  // this warpgroup's A slice := bf16(r * hprev), in place
        uint8_t* a = gbase + s * C::kStageBytes + wg * kSlice;
        const uint8_t* rv = a + kR * kSlice;
#pragma unroll
        for (int q = 0; q < kSlice / 16 / 128; ++q) {
          const int off = ((tid & 127) + 128 * q) * 16;
          uint4 h = *reinterpret_cast<const uint4*>(a + off);
          const uint4 r = *reinterpret_cast<const uint4*>(rv + off);
          h.x = mul_bf2(h.x, r.x);
          h.y = mul_bf2(h.y, r.y);
          h.z = mul_bf2(h.z, r.z);
          h.w = mul_bf2(h.w, r.w);
          *reinterpret_cast<uint4*>(a + off) = h;
        }
        fence_async();
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      }
      wg_fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k) {
        mma(acc, desc(st + wg * kSlice + k * 2048, kSlice, 1024),
            desc(st + 2 * kSlice + k * 2048, kSlice, 1024));
      }
      wg_commit();
      wg_wait<0>();  // the products of stage c are done: release it
      if ((tid & 127) == 0) {
        for (int r = 0; r < cm; ++r) mbar_arrive_at(empty0 + 8 * s, r);
      }
    }

    // accumulator i of thread t: row 16 * warp + lane / 4 (+ 8 for i % 4
    // >= 2), column 8 * (i / 4) + 2 * (lane % 4) (+ 1 for odd i)
    const int m = m0 + 64 * wg;
    if (m < op.M) {
      const int lane = tid & 31;
      const int row = m + 16 * ((tid & 127) >> 5) + (lane >> 2);
      float* const part =
          op.splits == 1
              ? nullptr
              : op.part + static_cast<size_t>(blockIdx.z) * op.M * op.G;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = j0 + 8 * j + 2 * (lane & 3);
        if (col >= op.G) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t o = static_cast<size_t>(row + 8 * h) * op.G + col;
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (op.splits == 1) {
            *reinterpret_cast<unsigned*>(op.dw + o) = f2_to_bf2(v0, v1);
          } else {
            *reinterpret_cast<float2*>(part + o) = make_float2(v0, v1);
          }
        }
      }
    }
  }
  cluster_sync();  // no block leaves while a peer may still signal it
}

}  // namespace tc

// ---- fp32: a register-blocked tile on the CUDA cores

namespace simt {

constexpr int kBM = 128, kBN = 128;  // output tile; 8 x 8 a thread
constexpr int kBK = 32;              // T*B rows a stage
constexpr int kStages = 2;
constexpr int kTile = kBK * kBM;     // floats of one operand a stage
static_assert(kBK % 8 == 0, "whole float4 copies for every thread");

template <bool GRU>
constexpr int smem_bytes() {
  return kStages * (GRU ? 3 : 2) * kTile * static_cast<int>(sizeof(float));
}

// One 128 x 128 tile of dW over one split's rows: 256 threads, each 8 x 8
// outputs. Warp w covers rows 64 * (w / 4).. and columns 32 * (w % 4)..;
// lane l takes 4 rows at r0 = .. + 4 * (l / 4) and r0 + 32, 4 columns at
// c0 = .. + 4 * (l % 4) and c0 + 16, so a warp's shared-memory reads of a
// row are 8 and 4 neighbouring float4s. The operands are staged
// [row][128] by cp.async, double-buffered; the GRU's c~ tiles stage r too
// and form r * hprev in shared memory once a stage has landed.
template <bool GRU>
__global__ void __launch_bounds__(256, 2)
    dw_fp32_kernel(const DwOps<float> op) {
  constexpr int kOps = GRU ? 3 : 2;  // A, dx (, r) a stage
  extern __shared__ float4 dw_smem4[];
  float* const sm = reinterpret_cast<float*>(dw_smem4);
  const int tid = threadIdx.x, wp = tid >> 5, ln = tid & 31;
  const int r0 = 64 * (wp >> 2) + 4 * (ln >> 2);
  const int c0 = 32 * (wp & 3) + 4 * (ln & 3);
  const int j0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int n_begin = blockIdx.z * op.per;
  const int n_end = min(op.n_rows, n_begin + op.per);
  const int n_chunks = (n_end - n_begin + kBK - 1) / kBK;
  const bool cand = GRU && j0 >= 2 * op.D;

  auto load = [&](int chunk) {
    float* st = sm + (chunk % kStages) * kOps * kTile;
    const int n0 = n_begin + chunk * kBK;
#pragma unroll
    for (int q = 0; q < kBK / 8; ++q) {  // kBK rows x 32 float4 an operand
      const int idx = tid + 256 * q;
      const int c4 = idx & 31, r = idx >> 5, half = c4 >> 4;
      const int n = n0 + r, m = m0 + 64 * half, col = j0 + 64 * half;
      const int in = 4 * (c4 & 15);
      const bool a_ok = n < n_end && m < op.M;
      const bool b_ok = n < n_end && col < op.G;
      const int off = r * kBM + 4 * c4;
      cp16(smem_u32(st + off), a_ok ? op.a_row(n, m) + in : op.dx, a_ok);
      cp16(smem_u32(st + kTile + off), b_ok ? op.dx_row(n, col) + in : op.dx,
           b_ok);
      if (cand) {
        cp16(smem_u32(st + 2 * kTile + off),
             a_ok ? op.r_row(n, m) + in : op.dx, a_ok);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) load(c);
    cp_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_wait<kStages - 2>();
    __syncthreads();  // stage c landed; every thread is done with c - 1
    const float* st = sm + (c % kStages) * kOps * kTile;
    if (cand) {  // A := r * hprev (fp32: the rounding is the identity)
      float* a = sm + (c % kStages) * kOps * kTile;
#pragma unroll
      for (int q = 0; q < kBK / 8; ++q) {
        const int off = 4 * (tid + 256 * q);
        float4 h = *reinterpret_cast<const float4*>(a + off);
        const float4 r = *reinterpret_cast<const float4*>(a + 2 * kTile +
                                                          off);
        h.x = r.x * h.x; h.y = r.y * h.y; h.z = r.z * h.z; h.w = r.w * h.w;
        *reinterpret_cast<float4*>(a + off) = h;
      }
      __syncthreads();
    }
    if (c + kStages - 1 < n_chunks) load(c + kStages - 1);
    cp_commit();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float* ar = st + k * kBM + r0;
      const float* br = st + kTile + k * kBN + c0;
      const float4 a0 = *reinterpret_cast<const float4*>(ar);
      const float4 a1 = *reinterpret_cast<const float4*>(ar + 32);
      const float4 b0 = *reinterpret_cast<const float4*>(br);
      const float4 b1 = *reinterpret_cast<const float4*>(br + 16);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  float* const out =
      op.splits == 1 ? op.dw
                     : op.part + static_cast<size_t>(blockIdx.z) * op.M * op.G;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + r0 + 32 * (i >> 2) + (i & 3);
    if (m0 + 64 * (wp >> 2) >= op.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = j0 + c0 + 16 * h;
      if (j0 + 64 * ((wp & 3) >> 1) >= op.G) continue;
      const size_t o = static_cast<size_t>(row) * op.G + col;
      store4(out + o, &acc[i][4 * h]);
    }
  }
}

}  // namespace simt

// out = the fp32 partials [splits][4 * n4] summed in split order, cast to
// T, four neighbours a thread (B15's db, the dW reductions)
template <typename T>
__global__ void sum_partials4_kernel(const float4* __restrict__ part,
                                     T* __restrict__ dw, int n4, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  for (int p = 0; p < splits; ++p) {
    const float4 q = part[static_cast<size_t>(p) * n4 + i];
    v[0] += q.x; v[1] += q.y; v[2] += q.z; v[3] += q.w;
  }
  store4(dw + static_cast<size_t>(i) * 4, v);
}

// ---------------------------------------------- LSTM forward (B10, B14)

// One block of 256 threads per tile of BB batch rows walks all T steps.
// Thread tid owns the hidden units k0 = 2*tid (+ 2*256 ...) and k0 + 1 of
// every row of the tile: it computes their four gate columns q*D + k
// (q = i, f, c~, o), so the whole cell update of a unit is in one thread
// and a step needs one barrier. The fp32 carries h and c are read and
// written only by their owner; h rounded to W's dtype (the operand of the
// next step's product) is double-buffered, as is (B14) the step's xe
// rows, which the block stages one step ahead.
//   B10: gates = x_t + h_lp @ W
//   B14: gates = (xe_t @ Wx + b) + h_lp @ W   (the Pallas sum order)
template <typename T, int BB, bool PROJ>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wx,
                    const T* __restrict__ bias, const T* __restrict__ w,
                    const float* __restrict__ lens, const T* __restrict__ h0,
                    const T* __restrict__ c0, T* __restrict__ hs,
                    T* __restrict__ cs, T* __restrict__ gates, int n_steps,
                    int B, int D, int E) {
  extern __shared__ float smem[];
  const int N = BB * D;
  float* h = smem;               // [BB][D] the fp32 carry h
  float* c = h + N;              // [BB][D] the fp32 carry c
  float* h_lp = c + N;           // [2][BB][D] h rounded to W's dtype
  float* xe_s = h_lp + 2 * N;    // B14: [2][BB][E] the step's xe rows
  __shared__ float len_s[BB];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * BB;
  const int G = 4 * D;
  for (int i = tid; i < N; i += kThreads) {
    const int b = i / D;
    const size_t o = static_cast<size_t>(b0 + b) * D + i % D;
    const float hv = b0 + b < B ? to_f(h0[o]) : 0.f;
    h[i] = hv;
    c[i] = b0 + b < B ? to_f(c0[o]) : 0.f;
    h_lp[i] = round_to<T>(hv);
    h_lp[N + i] = 0.f;
  }
  if constexpr (PROJ) {
    for (int i = tid; i < 2 * BB * E; i += kThreads) {
      const int b = (i / E) % BB;
      xe_s[i] = i < BB * E && b0 + b < B && n_steps > 0
                    ? to_f(x[static_cast<size_t>(b0 + b) * E + i % E])
                    : 0.f;
    }
  }
  if (tid < BB) len_s[tid] = b0 + tid < B ? lens[b0 + tid] : 0.f;
  __syncthreads();

  for (int t = 0; t < n_steps; ++t) {
    const int cur = t & 1;
    const float* hl = h_lp + cur * N;
    float* hl_next = h_lp + (cur ^ 1) * N;
    const size_t row0 = static_cast<size_t>(t) * B + b0;  // (t, b0)
    if constexpr (PROJ) {
      if (t + 1 < n_steps) {  // stage xe[t + 1] in the other buffer
        float* nxt = xe_s + (cur ^ 1) * BB * E;
        for (int i = tid; i < BB * E; i += kThreads) {
          const int b = i / E;
          if (b0 + b < B) nxt[i] = to_f(x[(row0 + B + b) * E + i % E]);
        }
      }
    }
    for (int k0 = 2 * tid; k0 < D; k0 += 2 * kThreads) {
      float pre[4][BB][2];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        cols_dot<T, BB, 2>(w + q * D + k0, G, hl, D, D, pre[q]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (PROJ) {
          float ax[BB][2], bq[2];
          cols_dot<T, BB, 2>(wx + q * D + k0, G, xe_s + cur * BB * E, E, E,
                             ax);
          load2(bias + q * D + k0, bq);
#pragma unroll
          for (int b = 0; b < BB; ++b)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc)
              pre[q][b][cc] = (ax[b][cc] + bq[cc]) + pre[q][b][cc];
        } else {
#pragma unroll
          for (int b = 0; b < BB; ++b) {
            if (b0 + b >= B) continue;
            float xv[2];
            load2(x + (row0 + b) * G + q * D + k0, xv);
#pragma unroll
            for (int cc = 0; cc < 2; ++cc)
              pre[q][b][cc] = xv[cc] + pre[q][b][cc];
          }
        }
      }
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        if (b0 + b >= B) continue;
        const float m = static_cast<float>(t) < len_s[b] ? 1.f : 0.f;
        float gv[4][2], hn[2], cn[2];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int i = b * D + k0 + cc;
          const float ig = sigmoid(pre[0][b][cc]);
          const float fg = sigmoid(pre[1][b][cc]);
          const float gg = tanhf(pre[2][b][cc]);
          const float og = sigmoid(pre[3][b][cc]);
          const float hp = h[i], cp = c[i];
          const float ct = fg * cp + ig * gg;
          const float ht = og * tanhf(ct);
          hn[cc] = m * ht + (1.f - m) * hp;
          cn[cc] = m * ct + (1.f - m) * cp;
          h[i] = hn[cc];
          c[i] = cn[cc];
          hl_next[i] = round_to<T>(hn[cc]);
          gv[0][cc] = ig;
          gv[1][cc] = fg;
          gv[2][cc] = gg;
          gv[3][cc] = og;
        }
        store2(hs + (row0 + b) * D + k0, hn);
        store2(cs + (row0 + b) * D + k0, cn);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          store2(gates + (row0 + b) * G + q * D + k0, gv[q]);
      }
    }
    __syncthreads();
  }
}

// --------------------------------------------- LSTM backward (B11, B15)

// The reverse recurrence, one block per tile of BB rows, reverse time.
// Phase 0 (elementwise): thread tid owns units k = tid (+ 256 ...) of
// every row: it recomputes c~ = f*c_prev + i*g from the saved gates and
// c_prev = [c0; cs[:-1]] as stored (in cs's dtype: the bf16 lane's c_prev
// is the rounded one, as in the Pallas kernel), forms the four
// pre-activation gate gradients, writes them (dx) and keeps them rounded
// to W's dtype in shared memory, updates dc and sets dh = (1-m)*dH; B15
// also sums the unrounded fp32 dgates of its units into db (the Pallas
// db sums fp32 dgates; dWx and dW sum the rounded ones).
// Phase 1: dh += dgates_lp @ W^T (D columns), and B15's dxe_t =
// dgates_lp @ Wx^T (E columns), both from transposed copies the wrapper
// makes once per call, 2 columns per thread.
template <typename T, int BB, bool PROJ>
__global__ void __launch_bounds__(kThreads)
    lstm_bwd_kernel(const T* __restrict__ gates, const T* __restrict__ cs,
                    const T* __restrict__ wt, const T* __restrict__ wxt,
                    const float* __restrict__ lens, const T* __restrict__ c0,
                    const T* __restrict__ dhs, const T* __restrict__ dcs,
                    T* __restrict__ dx, T* __restrict__ dxe,
                    float* __restrict__ db_part, T* __restrict__ dh0,
                    T* __restrict__ dc0, int n_steps, int B, int D, int E) {
  extern __shared__ float smem[];
  const int N = BB * D;
  const int G = 4 * D;
  float* dh = smem;              // [BB][D] the fp32 carry dh
  float* dc = dh + N;            // [BB][D] the fp32 carry dc
  float* dg = dc + N;            // [BB][4D] dgates rounded to W's dtype
  float* db_s = dg + BB * G;     // B15: [4D] this tile's fp32 sum of dgates
  __shared__ float len_s[BB];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * BB;
  for (int i = tid; i < N; i += kThreads) dh[i] = dc[i] = 0.f;
  for (int i = tid; i < BB * G; i += kThreads) dg[i] = 0.f;
  if constexpr (PROJ) {
    for (int i = tid; i < G; i += kThreads) db_s[i] = 0.f;
  }
  if (tid < BB) len_s[tid] = b0 + tid < B ? lens[b0 + tid] : 0.f;
  __syncthreads();

  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t row0 = static_cast<size_t>(t) * B + b0;
    // phase 0
    for (int k = tid; k < D; k += kThreads) {
      float dbk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        if (b0 + b >= B) continue;  // a padding row: dg stays 0
        const size_t n = row0 + b;
        const int i = b * D + k;
        const float ig = to_f(gates[n * G + k]);
        const float fg = to_f(gates[n * G + D + k]);
        const float gg = to_f(gates[n * G + 2 * D + k]);
        const float og = to_f(gates[n * G + 3 * D + k]);
        const float cp = to_f(t > 0 ? cs[(n - B) * D + k]
                                    : c0[static_cast<size_t>(b0 + b) * D + k]);
        const float ct = fg * cp + ig * gg;  // the pre-mask cell
        const float tc = tanhf(ct);
        const float m = static_cast<float>(t) < len_s[b] ? 1.f : 0.f;
        const float dH = to_f(dhs[n * D + k]) + dh[i];
        const float dC = to_f(dcs[n * D + k]) + dc[i];
        const float dht = m * dH;
        const float dct = m * dC + dht * og * (1.f - tc * tc);
        const float d[4] = {dct * gg * ig * (1.f - ig),
                            dct * cp * fg * (1.f - fg),
                            dct * ig * (1.f - gg * gg),
                            dht * tc * og * (1.f - og)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dx[n * G + q * D + k] = from_f<T>(d[q]);
          dg[b * G + q * D + k] = round_to<T>(d[q]);
          dbk[q] += d[q];
        }
        dc[i] = (1.f - m) * dC + dct * fg;
        dh[i] = (1.f - m) * dH;
      }
      if constexpr (PROJ) {
#pragma unroll
        for (int q = 0; q < 4; ++q) db_s[q * D + k] += dbk[q];
      }
    }
    __syncthreads();
    // phase 1: dh += dg @ W^T (wt [4D, D]); B15: dxe = dg @ Wx^T (wxt
    // [4D, E])
    const int n_cols = D + (PROJ ? E : 0);
    for (int k0 = 2 * tid; k0 < n_cols; k0 += 2 * kThreads) {
      float acc[BB][2];
      if (k0 < D) {
        cols_dot<T, BB, 2>(wt + k0, D, dg, G, G, acc);
#pragma unroll
        for (int b = 0; b < BB; ++b) {
          if (b0 + b >= B) continue;
          dh[b * D + k0] += acc[b][0];
          dh[b * D + k0 + 1] += acc[b][1];
        }
      } else {
        const int ke = k0 - D;
        cols_dot<T, BB, 2>(wxt + ke, E, dg, G, G, acc);
#pragma unroll
        for (int b = 0; b < BB; ++b) {
          if (b0 + b >= B) continue;
          store2(dxe + (row0 + b) * E + ke, acc[b]);
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < N; i += kThreads) {
    const int b = i / D;
    if (b0 + b >= B) continue;
    const size_t o = static_cast<size_t>(b0 + b) * D + i % D;
    dh0[o] = from_f<T>(dh[i]);
    dc0[o] = from_f<T>(dc[i]);
  }
  if constexpr (PROJ) {
    for (int i = tid; i < G; i += kThreads)
      db_part[static_cast<size_t>(blockIdx.x) * G + i] = db_s[i];
  }
}

// ------------------------------------------------------------- launchers

template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// lane 0: float32, 1: bfloat16; D a multiple of 64; BB in {1, 2, 4, 8}
bool bad_sizes(int lane, int n_steps, int B, int D, int bb) {
  return lane < 0 || lane > 1 || n_steps < 0 || B < 1 || D < 64 ||
         D % 64 != 0 || !(bb == 1 || bb == 2 || bb == 4 || bb == 8);
}

template <typename T, int BB>
cudaError_t launch_fwd(const void* x, const void* w, const float* lens,
                       const void* h0, void* hs, void* gates, int n_steps,
                       int B, int D, cudaStream_t st) {
  const int smem = kFwdArrays * BB * D * static_cast<int>(sizeof(float));
  const cudaError_t err = opt_in(gru_fwd_kernel<T, BB>, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((B + BB - 1) / BB);
  gru_fwd_kernel<T, BB><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), lens,
      static_cast<const T*>(h0), static_cast<T*>(hs), static_cast<T*>(gates),
      n_steps, B, D);
  return cudaGetLastError();
}

template <typename T, int BB>
cudaError_t launch_bwd(const void* gates, const void* hs, const void* wt,
                       const float* lens, const void* h0, const void* dhs,
                       void* dx, void* dh0, int n_steps, int B, int D,
                       cudaStream_t st) {
  const int smem = kBwdArrays * BB * D * static_cast<int>(sizeof(float));
  const cudaError_t err = opt_in(gru_bwd_kernel<T, BB>, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((B + BB - 1) / BB);
  gru_bwd_kernel<T, BB><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(gates), static_cast<const T*>(hs),
      static_cast<const T*>(wt), lens, static_cast<const T*>(h0),
      static_cast<const T*>(dhs), static_cast<T*>(dx), static_cast<T*>(dh0),
      n_steps, B, D);
  return cudaGetLastError();
}

// shared memory of the LSTM recurrence kernels (the wrapper's
// _lstm_smem_bytes computes the same)
int lstm_fwd_smem(int bb, int D, int E) {
  return (4 * bb * D + 2 * bb * E) * static_cast<int>(sizeof(float));
}
int lstm_bwd_smem(int bb, int D, bool proj) {
  return (6 * bb * D + (proj ? 4 * D : 0)) * static_cast<int>(sizeof(float));
}

template <typename T, int BB, bool PROJ>
cudaError_t launch_lstm_fwd(const void* x, const void* wx, const void* bias,
                            const void* w, const float* lens, const void* h0,
                            const void* c0, void* hs, void* cs, void* gates,
                            int n_steps, int B, int D, int E,
                            cudaStream_t st) {
  const int smem = lstm_fwd_smem(BB, D, PROJ ? E : 0);
  const cudaError_t err = opt_in(lstm_fwd_kernel<T, BB, PROJ>, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((B + BB - 1) / BB);
  lstm_fwd_kernel<T, BB, PROJ><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wx),
      static_cast<const T*>(bias), static_cast<const T*>(w), lens,
      static_cast<const T*>(h0), static_cast<const T*>(c0),
      static_cast<T*>(hs), static_cast<T*>(cs), static_cast<T*>(gates),
      n_steps, B, D, E);
  return cudaGetLastError();
}

template <typename T, int BB, bool PROJ>
cudaError_t launch_lstm_bwd(const void* gates, const void* cs, const void* wt,
                            const void* wxt, const float* lens, const void* c0,
                            const void* dhs, const void* dcs, void* dx,
                            void* dxe, float* db_part, float* db, void* dh0,
                            void* dc0, int n_steps, int B, int D, int E,
                            cudaStream_t st) {
  const int smem = lstm_bwd_smem(BB, D, PROJ);
  const cudaError_t err = opt_in(lstm_bwd_kernel<T, BB, PROJ>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + BB - 1) / BB;
  lstm_bwd_kernel<T, BB, PROJ><<<static_cast<unsigned>(grid), kThreads,
                                 smem, st>>>(
      static_cast<const T*>(gates), static_cast<const T*>(cs),
      static_cast<const T*>(wt), static_cast<const T*>(wxt), lens,
      static_cast<const T*>(c0), static_cast<const T*>(dhs),
      static_cast<const T*>(dcs), static_cast<T*>(dx), static_cast<T*>(dxe),
      db_part, static_cast<T*>(dh0), static_cast<T*>(dc0), n_steps, B, D,
      E);
  if constexpr (PROJ) {  // db: the tiles' fp32 partials summed in order
    sum_partials4_kernel<float><<<(D + 255) / 256, 256, 0, st>>>(
        reinterpret_cast<const float4*>(db_part), db, D, grid);
  }
  return cudaGetLastError();
}

// a tensor map of a row-major [rows, cols] tensor of `type` (elements of
// `size` bytes, row stride ld elements) in box_cols x rows_box boxes and
// the 128-byte swizzle, through the driver's cuTensorMapEncodeTiled (found
// through the runtime: no -lcuda)
cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type, int size,
                       const void* base, int rows, int cols, int ld,
                       int box_cols, int rows_box) {
  static const PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                         12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      fn = nullptr;
    }
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * size};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(rows_box)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(base), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ... of a bf16 tensor in 64-column boxes
cudaError_t bf16_tensor_map(CUtensorMap* map, const void* base, int rows,
                            int cols, int ld, int rows_box) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows,
                    cols, ld, 64, rows_box);
}

template <bool GRU, int BN>
cudaError_t launch_dw_wgmma(DwOps<bf16> op, cudaStream_t st) {
  using C = tc::Cfg<GRU, BN>;
  cudaError_t err = opt_in(tc::dw_wgmma_kernel<GRU, BN>, C::kSmem);
  if (err != cudaSuccess) return err;
  tc::DwMaps maps;
  const int rows = op.n_rows, bk = C::kBK;
  err = bf16_tensor_map(&maps.dx, op.dx, rows, op.G, op.G, bk);
  if (err == cudaSuccess) {
    err = bf16_tensor_map(&maps.hs, op.hs, rows, op.D, op.D, bk);
  }
  if (err == cudaSuccess) {
    err = bf16_tensor_map(&maps.h0, op.h0, op.B, op.D, op.D, bk);
  }
  maps.xe = maps.hs;  // unused unless E > 0
  if (err == cudaSuccess && op.E > 0) {
    err = bf16_tensor_map(&maps.xe, op.xe, rows, op.E, op.E, bk);
  }
  maps.gates = maps.hs;  // unused unless GRU
  if (err == cudaSuccess && GRU) {
    err = bf16_tensor_map(&maps.gates, op.gates, rows, 3 * op.D, 3 * op.D,
                          bk);
  }
  if (err != cudaSuccess) return err;
  const int m_tiles = (op.M + tc::kBM - 1) / tc::kBM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 2;  // pairs of row tiles share dx
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((op.G + BN - 1) / BN),
                     static_cast<unsigned>(m_tiles),
                     static_cast<unsigned>(op.splits));
  cfg.blockDim = dim3(288);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // pairs the card holds at once (its GPCs' SM counts set it); a grid of
  // pairs that does not fit in one wave runs without clusters instead
  static int pairs = -1;
  if (pairs < 0) {
    cudaLaunchConfig_t one = cfg;  // any grid of whole pairs
    one.gridDim = dim3(1, 2, 1);
    if (cudaOccupancyMaxActiveClusters(&pairs, tc::dw_wgmma_kernel<GRU, BN>,
                                       &one) != cudaSuccess) {
      pairs = 0;
      (void)cudaGetLastError();
    }
  }
  const int blocks = static_cast<int>(cfg.gridDim.x * cfg.gridDim.y *
                                      cfg.gridDim.z);
  op.cluster = m_tiles % 2 == 0 && 2 * pairs >= blocks ? 2 : 1;
  attr[0].val.clusterDim.y = static_cast<unsigned>(op.cluster);
  return cudaLaunchKernelEx(&cfg, tc::dw_wgmma_kernel<GRU, BN>, op, maps);
}

template <bool GRU>
cudaError_t launch_dw_fp32(const DwOps<float>& op, cudaStream_t st) {
  constexpr int smem = simt::smem_bytes<GRU>();
  const cudaError_t err = opt_in(simt::dw_fp32_kernel<GRU>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((op.G + simt::kBN - 1) / simt::kBN),
                  static_cast<unsigned>((op.M + simt::kBM - 1) / simt::kBM),
                  static_cast<unsigned>(op.splits));
  simt::dw_fp32_kernel<GRU><<<grid, 256, smem, st>>>(op);
  return cudaGetLastError();
}

// One dW reduction (GRU: [D, 3D]; LSTM: [E + D, 4D]): the tile kernel of
// the lane (bf16: wgmma, 128 x 256 tiles, 128 x 128 for a GRU whose 2D is
// no multiple of 256 so that no tile straddles the c~ columns; fp32:
// CUDA cores, 128 x 128), then, with splits > 1, the ordered sum. splits
// must leave no split empty (the wrapper's dw_plan).
template <typename T, bool GRU>
cudaError_t launch_dw(const void* xe, const void* hs, const void* h0,
                      const void* gates, const void* dx, float* part,
                      void* dw, int n_steps, int B, int D, int E, int splits,
                      cudaStream_t st) {
  const int n_rows = n_steps * B;
  const int per = dw_rows_per_split(n_rows, splits);
  if (splits != (n_rows > per ? (n_rows + per - 1) / per : 1)) {
    return cudaErrorInvalidValue;
  }
  const DwOps<T> op{static_cast<const T*>(xe), static_cast<const T*>(hs),
                    static_cast<const T*>(h0), static_cast<const T*>(gates),
                    static_cast<const T*>(dx), part, static_cast<T*>(dw),
                    n_rows, B, D, E, (GRU ? 3 : 4) * D, E + D, per, splits,
                    1};
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    err = launch_dw_fp32<GRU>(op, st);
  } else if constexpr (GRU) {
    err = D % 128 ? launch_dw_wgmma<true, 128>(op, st)
                  : launch_dw_wgmma<true, 256>(op, st);
  } else {
    err = launch_dw_wgmma<false, 256>(op, st);
  }
  if (err != cudaSuccess || splits == 1) return err;
  const int n4 = op.M * op.G / 4;
  sum_partials4_kernel<T><<<(n4 + 255) / 256, 256, 0, st>>>(
      reinterpret_cast<const float4*>(part), static_cast<T*>(dw), n4, splits);
  return cudaGetLastError();
}

// E (the B14/B15 input width): a multiple of 64 (the dWx tiles)
bool bad_e(int E) { return E < 64 || E % 64 != 0; }

// ------------------------- B14/B15 bf16: the resident route (rc)
//
// Three launches stand in for the bf16 lstm_proj_fwd / lstm_proj_bwd
// recurrence kernels above (notes at the top of the file):
//   lstm_xg_kernel           xg [T*B, 4D] fp32 = xe @ Wx + b, every step
//                            at once (proj_gemm: wgmma, TMA, persistent);
//   lstm_cluster_fwd_kernel  the forward recurrence from xg, W resident;
//   lstm_cluster_bwd_kernel  the reverse recurrence: dx, db, dh0, dc0;
//   lstm_dxe_kernel          dxe [T*B, E] = dx @ Wx^T (the GEMM of the
//                            pre-pass with B read transposed, bf16 out).
namespace rc {

constexpr int kU = 32;          // hidden units a CTA of a cluster owns
constexpr int kN = 4 * kU;      // the LSTM's gate columns: i|f|c~|o of them
constexpr int kThreads = 256;   // 8 warps
constexpr int kMaxCluster = 16;
constexpr int kLdg = kN + 8;    // row stride of the LSTM's dgates tile (bf16)

// shared memory (bytes) of the recurrences of ng gates (4: the LSTM, 3:
// the GRU) for tiles of 16 * mt rows: W's slice [ng * kU][D + 8] bf16
// (rows padded by 16 bytes, so ldmatrix's eight row addresses fall on
// distinct banks), then the forward's two [BB][D + 8] bf16 buffers (the
// LSTM's h, double-buffered; the GRU's h and r * h), its staged slice
// [BB][kU] bf16 and the K halves' partial sums [4][mt][ng][32][4] fp32;
// the backward's dgates tile [BB][ng * kU + 8] bf16 and the
// reduce-scatter slots [nc][BB][kU] fp32
constexpr int fwd_smem(int mt, int D, int ng = 4) {
  return 2 * (ng * kU * (D + 8) + 2 * 16 * mt * (D + 8) + 16 * mt * kU) +
         4 * (4 * mt * ng * 32 * 4);
}
constexpr int bwd_smem(int mt, int D, int ng = 4) {
  return 2 * (ng * kU * (D + 8) + 16 * mt * (ng * kU + 8)) +
         4 * (D / kU) * 16 * mt * kU;
}
constexpr int probe_smem(int mt, int D) {
  return fwd_smem(mt, D) > bwd_smem(mt, D) ? fwd_smem(mt, D)
                                           : bwd_smem(mt, D);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the hardware cluster barrier in two halves: writes to any CTA's shared
// memory before a thread's arrive are seen by every thread after its wait
// (.aligned: every lane of the warp executes it together)
__device__ __forceinline__ void cl_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cl_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// 16 / 8 bytes into CTA `rank`'s shared memory at the offset of addr
__device__ __forceinline__ void st_cl16(uint32_t addr, uint32_t rank,
                                        uint4 v) {
  asm volatile(
      "{\n.reg .b32 a;\nmapa.shared::cluster.u32 a, %0, %1;\n"
      "st.shared::cluster.v4.u32 [a], {%2, %3, %4, %5};\n}\n" ::"r"(addr),
      "r"(rank), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
      : "memory");
}
__device__ __forceinline__ void st_cl8(uint32_t addr, uint32_t rank,
                                       float a, float b) {
  asm volatile(
      "{\n.reg .b32 a;\nmapa.shared::cluster.u32 a, %0, %1;\n"
      "st.shared::cluster.v2.f32 [a], {%2, %3};\n}\n" ::"r"(addr),
      "r"(rank), "f"(a), "f"(b)
      : "memory");
}
// four 8 x 8 b16 matrices (lanes 8i..8i+7 give matrix i's row addresses;
// lane 4g + t receives elements 2t, 2t + 1 of row g of each), two of
// them (lanes 0-15's addresses), and the transposed form (lane 4g + t
// receives rows 2t, 2t + 1 of column g)
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t r[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 sums. Fragments
// (lane 4g + t): a0 = A[g][2t, 2t+1], a1 = A[g+8][..], a2 = A[g][2t+8,
// 2t+9], a3 = A[g+8][..]; b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g];
// d0, d1 = D[g][2t, 2t+1], d2, d3 = D[g+8][2t, 2t+1]
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ws[n][k] = W[k][(n / U) * D + u0 + n % U] (n < NG * U, k < D): the
// CTA's gate columns of W [D, NG * D] for its U units, transposed, eight k
// to a 16-byte store; four such items a thread at a time, so that 32
// loads are in flight
template <int NG, int U = kU>
__device__ __forceinline__ void load_w_slice(const bf16* __restrict__ w,
                                             bf16* ws, int D, int u0) {
  constexpr int kBatch = 4, kN = NG * U;
  const int G = NG * D, ld = D + 8, total = kN * (D / 8);
  const unsigned short* wu = reinterpret_cast<const unsigned short*>(w);
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kThreads) {
    uint32_t v[kBatch][4];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int n = i % kN, k0 = 8 * (i / kN);
      const unsigned short* src =
          wu + static_cast<size_t>(k0) * G + (n / U) * D + u0 + n % U;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[u][j] = i < total
                      ? static_cast<uint32_t>(__ldg(src + 2 * j * G)) |
                            static_cast<uint32_t>(
                                __ldg(src + (2 * j + 1) * G)) << 16
                      : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total) {
        *reinterpret_cast<uint4*>(ws + (i % kN) * ld + 8 * (i / kN)) =
            make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
      }
    }
  }
}

// the tile's new h slice hst [BB][kU] into the h buffer `hnext` [BB][ld]
// of every CTA of the cluster, at this CTA's columns u0..u0+31. The
// destinations are taken in an order rotated by the sender's rank, so
// that the CTAs' stores spread over every receiver at once.
template <int BB>
__device__ __forceinline__ void push_h(const bf16* hst, const bf16* hnext,
                                       int ld, int u0, int nc, int me) {
  const uint32_t dst0 = smem_u32(hnext + u0);
  for (int i = threadIdx.x; i < nc * BB * 4; i += kThreads) {
    const int part = i & 3, r = (i >> 2) % BB;
    const uint32_t rank = static_cast<uint32_t>((i / (4 * BB) + me) % nc);
    const uint4 v = *reinterpret_cast<const uint4*>(hst + r * kU + 8 * part);
    st_cl16(dst0 + 2 * (r * ld + 8 * part), rank, v);
  }
}

// the n-tile (8 of the D columns) that warp `warp` of CTA `rank` takes as
// its j-th in the backward's product: warp + 8 j' with j' = j + rank
// (mod 8), so that, j by j, the CTAs' partials go to different owners
__device__ __forceinline__ int bwd_tile(int warp, int j, int rank) {
  return warp + 8 * ((j + rank) & 7);
}

// the reverse's partial product on the tensor cores: acc [BB][this
// warp's n-tiles of D] = dg[:, K0:K1] x W_slice[K0:K1][:], dg the
// dgates tile (bf16, row stride LDG; a_addr its lane's ldmatrix address)
// and W_slice the resident slice's rows n, read as they lie by
// ldmatrix.trans (b_addr: row lane % 16), so that no transposed copy of
// W is made. Warp w takes the n-tiles bwd_tile(w, j, rank), j < 8, their
// B fragments loaded in pairs before the products; K runs in order.
template <int MT, int K0, int K1, int LDG>
__device__ __forceinline__ void slice_t_product(float (&acc)[MT][8][4],
                                                uint32_t a_addr,
                                                uint32_t b_addr, int ld,
                                                int n_nt, int warp,
                                                int lane, int rank) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
#pragma unroll
  for (int k = K0; k < K1; k += 16) {
    uint32_t a[MT][4], bf[8][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(a_addr + 2 * (16 * mt * LDG + k), a[mt]);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      // n-tiles j (lanes 0-15's rows) and j + 1 (lanes 16-31's), each
      // clamped into range: a tile past D is loaded, never multiplied
      const int nt = min(bwd_tile(warp, j + (lane >> 4), rank), n_nt - 1);
      uint32_t r[4];
      ldsm_x4_t(b_addr + 2 * (k * ld + 8 * nt), r);
      bf[j][0] = r[0]; bf[j][1] = r[1]; bf[j + 1][0] = r[2];
      bf[j + 1][1] = r[3];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (bwd_tile(warp, j, rank) >= n_nt) continue;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_bf16(acc[mt][j], a[mt], bf[j][0], bf[j][1]);
    }
  }
}

// the backward's partial dh_prev (this warp's n-tiles) into slot `rank`
// of each column's owner: CTA n / kU
template <int MT>
__device__ __forceinline__ void push_partials(const float (&acc)[MT][8][4],
                                              const float* slot, int rank,
                                              int n_nt, int warp, int lane) {
  constexpr int BB = 16 * MT;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int nt = bwd_tile(warp, j, rank);
    if (nt >= n_nt) continue;
    const int n0 = 8 * nt;
    const uint32_t owner = static_cast<uint32_t>(n0 / kU);
    const int col = n0 % kU + 2 * t4;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = 16 * mt + g + 8 * rr;
        st_cl8(smem_u32(slot + (rank * BB + row) * kU + col), owner,
               acc[mt][j][2 * rr], acc[mt][j][2 * rr + 1]);
      }
    }
  }
}

// one cell's step from its four pre-activations p0..p3 (i, f, c~, o):
// the fp32 carries hp, cp updated under the step's mask m, the four
// activations out (scalars throughout, so that nothing leaves registers)
__device__ __forceinline__ void cell(float p0, float p1, float p2, float p3,
                                     float m, float& hp, float& cp,
                                     float& g0, float& g1, float& g2,
                                     float& g3) {
  g0 = sigmoid(p0);
  g1 = sigmoid(p1);
  g2 = tanhf(p2);
  g3 = sigmoid(p3);
  const float ct = g1 * cp + g0 * g2;
  const float ht = g3 * tanhf(ct);
  hp = m * ht + (1.f - m) * hp;
  cp = m * ct + (1.f - m) * cp;
}

// the step's first term at one unit pair as fp32: B14's xg (fp32, eight
// bytes) or B10's x (bf16, four bytes widened: exact)
__device__ __forceinline__ float2 ld_first(const float* p) {
  return __ldcs(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ld_first(const bf16* p) {
  return bf2_to_f2(__ldcs(reinterpret_cast<const unsigned*>(p)));
}

// the first term of step t (xg, or x) for this thread's cells: rows 16 mt
// + g + 8 kh, units uc, uc + 1, each of the NG gates (zeros on padding
// rows)
template <int MT, int NG, typename XT>
__device__ __forceinline__ void load_xg(const XT* __restrict__ xg,
                                        float (&xv)[MT][NG][2], int t, int B,
                                        int D, int row0, int uc) {
  const int G = NG * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int b = row0 + 16 * mt;
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      float2 v = make_float2(0.f, 0.f);
      if (b < B) {
        v = ld_first(xg + (static_cast<size_t>(t) * B + b) * G + q * D + uc);
      }
      xv[mt][q][0] = v.x;
      xv[mt][q][1] = v.y;
    }
  }
}

// B14's (and B10's) recurrence. One cluster of nc = D / 32 CTAs per tile
// of BB = 16 MT batch rows; CTA `rank` owns hidden units u0 = 32 rank ..
// u0 + 31 and keeps its 128 columns of W in shared memory for all T
// steps. Per step each of its 8 warps multiplies the tile's h (bf16, the
// whole [BB, D], in the step's h buffer) by W's slice on the tensor
// cores: warp w takes the 8 units 8 (w % 4).. of all four gates over half
// of K (kh = w / 4).
// The halves meet in shared memory: each warp hands the other half's
// rows to its partner (the same units, the other K half) and takes its
// own, so warps kh update the cells of rows 16 mt + g + 8 kh; the cells'
// fp32 carries h and c never leave their registers. The new h slice
// (bf16) goes to every CTA's other h buffer by DSMEM; one cluster barrier
// (arrive after the stores, wait before the next product) ends the step,
// and the step's hs, cs and gates are written to global memory between
// its two halves. XT is the type of the step's first term: float for
// B14's xg (the pre-pass's fp32 sums), bf16 for B10's x (the
// pre-projected gates as dynamic_lstm passes them); each value is widened
// to fp32 as it is loaded, and nothing else of the step depends on XT.
template <int MT, typename XT>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_cluster_fwd_kernel(const XT* __restrict__ xg,
                            const bf16* __restrict__ w,
                            const float* __restrict__ lens,
                            const bf16* __restrict__ h0,
                            const bf16* __restrict__ c0,
                            bf16* __restrict__ hs, bf16* __restrict__ cs,
                            bf16* __restrict__ gates, int n_steps, int B,
                            int D) {
  constexpr int BB = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_rc[];
  const int ld = D + 8, G = 4 * D, nc = D / kU;
  bf16* ws = reinterpret_cast<bf16*>(smem_rc);
  bf16* hb = ws + kN * ld;              // [2][BB][ld]
  bf16* hst = hb + 2 * BB * ld;         // [BB][kU]
  float* red = reinterpret_cast<float*>(hst + BB * kU);  // [2][4][MT][4][32][2]
  const int rank = static_cast<int>(cluster_rank());
  const int u0 = rank * kU;
  const int b0 = static_cast<int>(blockIdx.x) / nc * BB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ug = warp & 3, kh = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int uc = u0 + 8 * ug + 2 * t4;  // the first unit of a cell pair
  const int rl = g + 8 * kh;            // the cells' row in each m-tile

  load_w_slice<4>(w, ws, D, u0);
  for (int i = tid; i < BB * (D / 8); i += kThreads) {
    const int r = i / (D / 8), k0 = 8 * (i % (D / 8));
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (b0 + r < B) {
      v = *reinterpret_cast<const uint4*>(
          h0 + static_cast<size_t>(b0 + r) * D + k0);
    }
    *reinterpret_cast<uint4*>(hb + r * ld + k0) = v;
  }
  float hc[MT][2], cc[MT][2], len[MT], xv[MT][4][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int b = b0 + 16 * mt + rl;
    const size_t o = static_cast<size_t>(b) * D + uc;
    len[mt] = b < B ? lens[b] : 0.f;
#pragma unroll
    for (int cu = 0; cu < 2; ++cu) {
      hc[mt][cu] = b < B ? to_f(h0[o + cu]) : 0.f;
      cc[mt][cu] = b < B ? to_f(c0[o + cu]) : 0.f;
    }
  }
  if (n_steps > 0) load_xg<MT>(xg, xv, 0, B, D, b0 + rl, uc);
  __syncthreads();
  cl_arrive();  // the first wait: every CTA has started, its h0 in place

  // per-lane ldmatrix addresses: A (h rows), B (W slice rows of the
  // warp's units, gates q and q + 1 by lane / 16)
  const uint32_t a_lane = static_cast<uint32_t>(
      2 * (((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 8 * (lane >> 4)));
  const uint32_t b_addr = smem_u32(
      ws + ((lane >> 4) * kU + 8 * ug + (lane & 7)) * ld +
      8 * ((lane >> 3) & 1));
  const int kb = kh * (D / 2);
  // this warp's partials for its partner's rows, and the partner's for
  // this one's: [writer's kh][ug][mt][q][lane] float2
  float* red_out = red + ((kh * 4 + ug) * MT * 4 * 32 + lane) * 2;
  const float* red_in = red + (((kh ^ 1) * 4 + ug) * MT * 4 * 32 + lane) * 2;
  for (int t = 0; t < n_steps; ++t) {
    const int cur = t & 1;
    const uint32_t a_addr = smem_u32(hb + cur * BB * ld) + a_lane;
    cl_wait();  // h_t is whole in buffer cur
    float acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][q][e] = 0.f;
    for (int k = kb; k < kb + D / 2; k += 16) {
      uint32_t bq[2][4];  // gates 0, 1 and gates 2, 3
      ldsm_x4(b_addr + 2 * k, bq[0]);
      ldsm_x4(b_addr + 2 * (2 * kU * ld + k), bq[1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldsm_x4(a_addr + 2 * (16 * mt * ld + k), a);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma_bf16(acc[mt][q], a, bq[q >> 1][2 * (q & 1)],
                   bq[q >> 1][2 * (q & 1) + 1]);
      }
    }
    // a fragment's rows g (elements 0, 1) and g + 8 (2, 3): this warp's
    // cells are one pair, its partner's the other (selects, not an index
    // by kh, which would put acc in local memory)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float2*>(red_out + (mt * 4 + q) * 32 * 2) =
            kh ? make_float2(acc[mt][q][0], acc[mt][q][1])
               : make_float2(acc[mt][q][2], acc[mt][q][3]);
    __syncthreads();
    float gv[MT][4][2];  // the activations: [mt][gate][unit]
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float m = static_cast<float>(t) < len[mt] ? 1.f : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 p =
            *reinterpret_cast<const float2*>(red_in + (mt * 4 + q) * 32 * 2);
        // (xe_t Wx + b) + h_lp W, h_lp W the two K halves' sum
        const float m0 = kh ? acc[mt][q][2] : acc[mt][q][0];
        const float m1 = kh ? acc[mt][q][3] : acc[mt][q][1];
        acc[mt][q][0] = xv[mt][q][0] + (m0 + p.x);
        acc[mt][q][1] = xv[mt][q][1] + (m1 + p.y);
      }
#pragma unroll
      for (int cu = 0; cu < 2; ++cu)
        cell(acc[mt][0][cu], acc[mt][1][cu], acc[mt][2][cu], acc[mt][3][cu],
             m, hc[mt][cu], cc[mt][cu], gv[mt][0][cu], gv[mt][1][cu],
             gv[mt][2][cu], gv[mt][3][cu]);
      *reinterpret_cast<uint32_t*>(hst + (16 * mt + rl) * kU + 8 * ug +
                                   2 * t4) = f2_to_bf2(hc[mt][0], hc[mt][1]);
    }
    __syncthreads();  // the slice is staged; red is read
    push_h<BB>(hst, hb + (cur ^ 1) * BB * ld, ld, u0, nc, rank);
    cl_arrive();
    // the step's outputs, then the next step's xg
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int b = b0 + 16 * mt + rl;
      if (b >= B) continue;
      const size_t row = static_cast<size_t>(t) * B + b;
      store2(hs + row * D + uc, hc[mt]);
      store2(cs + row * D + uc, cc[mt]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        store2(gates + row * G + q * D + uc, gv[mt][q]);
    }
    if (t + 1 < n_steps) load_xg<MT>(xg, xv, t + 1, B, D, b0 + rl, uc);
  }
  cl_wait();  // no CTA writes into this one's shared memory any more
}

// the backward's inputs of step t for this thread's cells (rows r0 + 16
// i, units gu, gu + 1): the four saved gates, c_prev as stored, dhs and
// dcs, four bytes a load
template <int MT>
__device__ __forceinline__ void load_bwd(
    const bf16* __restrict__ gates, const bf16* __restrict__ cs,
    const bf16* __restrict__ c0, const bf16* __restrict__ dhs,
    const bf16* __restrict__ dcs, float (&gq)[MT][4][2], float (&cp)[MT][2],
    float (&dhv)[MT][2], float (&dcv)[MT][2], int t, int B, int D, int row0,
    int gu) {
  const int G = 4 * D;
  auto ld2 = [](const bf16* p, float* v) {
    const float2 f = bf2_to_f2(*reinterpret_cast<const unsigned*>(p));
    v[0] = f.x;
    v[1] = f.y;
  };
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int b = row0 + 16 * i;
    if (b >= B) {
#pragma unroll
      for (int cu = 0; cu < 2; ++cu) {
        gq[i][0][cu] = gq[i][1][cu] = gq[i][2][cu] = gq[i][3][cu] = 0.f;
        cp[i][cu] = dhv[i][cu] = dcv[i][cu] = 0.f;
      }
      continue;
    }
    const size_t n = static_cast<size_t>(t) * B + b;
#pragma unroll
    for (int q = 0; q < 4; ++q) ld2(gates + n * G + q * D + gu, gq[i][q]);
    ld2(t > 0 ? cs + (n - B) * D + gu : c0 + static_cast<size_t>(b) * D + gu,
        cp[i]);
    ld2(dhs + n * D + gu, dhv[i]);
    ld2(dcs + n * D + gu, dcv[i]);
  }
}

// B15's (and B11's) recurrence, reverse time; the clusters, tiles and W
// slices of the forward. Per step: (1) thread (warp, lane) forms the
// dgates of its cells (rows 2 warp + lane / 16 + 16 i, units u0 + 2 (lane
// % 16) and the next) from its fp32 carries dh, dc and the step's inputs
// (fetched a step ahead, during the previous step's barrier wait), writes
// dx, keeps
// the unrounded dgates' sum for db and the dgates rounded to bf16 in the
// shared tile [BB][128]; (2) the partial dh_prev = dgates_lp [BB, 128] x
// W_slice^T [128, D] on the tensor cores, read from the same resident
// slice by ldmatrix.trans (no transposed copy of W): warp w takes the
// n-tiles w, w + 8, ... (in bwd_tile's order), their B fragments loaded
// in pairs before the products; (3) reduce-scatter: each partial column
// block goes to its owner's slot for this CTA (DSMEM); cluster barrier;
// each owner sums the nc slots in rank order (two launches give the same
// bits) into its dh carry; a second barrier, split around the next
// step's work, frees the slots. kDb: B15 keeps db's partials (db_part);
// B11 has no db, and with kDb false nothing of it is kept or written.
template <int MT, bool kDb>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_cluster_bwd_kernel(const bf16* __restrict__ gates,
                            const bf16* __restrict__ cs,
                            const bf16* __restrict__ w,
                            const float* __restrict__ lens,
                            const bf16* __restrict__ c0,
                            const bf16* __restrict__ dhs,
                            const bf16* __restrict__ dcs,
                            bf16* __restrict__ dx,
                            float* __restrict__ db_part,
                            bf16* __restrict__ dh0, bf16* __restrict__ dc0,
                            int n_steps, int B, int D) {
  constexpr int BB = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_rc[];
  const int ld = D + 8, G = 4 * D, nc = D / kU, n_nt = D / 8;
  bf16* ws = reinterpret_cast<bf16*>(smem_rc);
  bf16* dg = ws + kN * ld;                                // [BB][kLdg]
  float* slot = reinterpret_cast<float*>(dg + BB * kLdg);  // [nc][BB][kU]
  const int rank = static_cast<int>(cluster_rank());
  const int u0 = rank * kU;
  const int tile = static_cast<int>(blockIdx.x) / nc;
  const int b0 = tile * BB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int up = 2 * (lane & 15);        // the cells' first local unit
  const int gu = u0 + up;
  const int r0 = 2 * warp + (lane >> 4);  // their row in each 16 rows

  load_w_slice<4>(w, ws, D, u0);
  float dh[MT][2], dc[MT][2], keep[MT][2], len[MT], dbq[4][2];
  float gq[MT][4][2], cp[MT][2], dhv[MT][2], dcv[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int b = b0 + r0 + 16 * i;
    len[i] = b < B ? lens[b] : 0.f;
#pragma unroll
    for (int cu = 0; cu < 2; ++cu) dh[i][cu] = dc[i][cu] = keep[i][cu] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) dbq[q][0] = dbq[q][1] = 0.f;
  if (n_steps > 0) {
    load_bwd<MT>(gates, cs, c0, dhs, dcs, gq, cp, dhv, dcv, n_steps - 1, B,
                 D, b0 + r0, gu);
  }
  __syncthreads();
  cl_arrive();  // pairs with the first step's wait before its stores

  const uint32_t a_addr = smem_u32(
      dg + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLdg + 8 * (lane >> 4));
  const uint32_t b_addr = smem_u32(ws + (lane & 15) * ld);
  for (int t = n_steps - 1; t >= 0; --t) {
    // (1) the cells
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = r0 + 16 * i, b = b0 + r;
      const float m = static_cast<float>(t) < len[i] ? 1.f : 0.f;
      float d[4][2];
#pragma unroll
      for (int cu = 0; cu < 2; ++cu) {
        const float ig = gq[i][0][cu], fg = gq[i][1][cu];
        const float gg = gq[i][2][cu], og = gq[i][3][cu];
        const float ct = fg * cp[i][cu] + ig * gg;  // the pre-mask cell
        const float tc = tanhf(ct);
        const float dH = dhv[i][cu] + dh[i][cu];
        const float dC = dcv[i][cu] + dc[i][cu];
        const float dht = m * dH;
        const float dct = m * dC + dht * og * (1.f - tc * tc);
        d[0][cu] = dct * gg * ig * (1.f - ig);
        d[1][cu] = dct * cp[i][cu] * fg * (1.f - fg);
        d[2][cu] = dct * ig * (1.f - gg * gg);
        d[3][cu] = dht * tc * og * (1.f - og);
        dc[i][cu] = (1.f - m) * dC + dct * fg;
        keep[i][cu] = (1.f - m) * dH;
      }
      if (b < B) {
        const size_t n = static_cast<size_t>(t) * B + b;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          store2(dx + n * G + q * D + gu, d[q]);
          if (kDb) {
            dbq[q][0] += d[q][0];
            dbq[q][1] += d[q][1];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)  // padding rows: zeros (their inputs are)
        *reinterpret_cast<uint32_t*>(dg + r * kLdg + q * kU + up) =
            f2_to_bf2(d[q][0], d[q][1]);
    }
    __syncthreads();  // the dgates tile is whole
    // (2) the partial product
    float acc[MT][8][4];
    slice_t_product<MT, 0, kN, kLdg>(acc, a_addr, b_addr, ld, n_nt, warp,
                                     lane, rank);
    // (3) reduce-scatter
    cl_wait();  // every owner has summed the slots of the step before
    push_partials<MT>(acc, slot, rank, n_nt, warp, lane);
    cl_arrive();
    if (t > 0) {  // the next step's inputs, in flight across the barrier
      load_bwd<MT>(gates, cs, c0, dhs, dcs, gq, cp, dhv, dcv, t - 1, B, D,
                   b0 + r0, gu);
    }
    cl_wait();  // every partial is in its owner's slots
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = r0 + 16 * i;
      float s[2] = {0.f, 0.f};
      for (int j = 0; j < nc; ++j) {
        const float2 v =
            *reinterpret_cast<const float2*>(slot + (j * BB + r) * kU + up);
        s[0] += v.x;
        s[1] += v.y;
      }
      dh[i][0] = keep[i][0] + s[0];  // (1 - m) dH + dgates_lp W^T
      dh[i][1] = keep[i][1] + s[1];
    }
    cl_arrive();
  }
  cl_wait();  // no CTA writes into this one's shared memory any more
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int b = b0 + r0 + 16 * i;
    if (b >= B) continue;
    store2(dh0 + static_cast<size_t>(b) * D + gu, dh[i]);
    store2(dc0 + static_cast<size_t>(b) * D + gu, dc[i]);
  }
  if (!kDb) return;
  // db: the 16 row groups' sums (each over its rows, in step order)
  // summed in group order into this tile's partial row
  float* dbs = reinterpret_cast<float*>(smem_rc);  // W's slice is done
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q)
    *reinterpret_cast<float2*>(dbs + r0 * kN + q * kU + up) =
        make_float2(dbq[q][0], dbq[q][1]);
  __syncthreads();
  if (tid < kN) {
    float s = 0.f;
    for (int j = 0; j < 16; ++j) s += dbs[j * kN + tid];
    db_part[static_cast<size_t>(tile) * G + (tid / kU) * D + u0 +
            tid % kU] = s;
  }
}

// The cluster exchange alone, for T steps of an empty recurrence at the
// kernels' tile: mode 0 the forward's (stage the h slice, DSMEM to every
// CTA, one barrier), mode 1 the backward's (partials to their owners'
// slots, barrier, the owners' sums, a second barrier), mode 2 the
// barrier alone. out[cta] keeps a value read from the exchanged buffers,
// so nothing is optimized away.
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_cluster_probe_kernel(float* __restrict__ out, int n_steps, int D,
                              int mode) {
  constexpr int BB = 16 * MT, R = BB / 8;
  extern __shared__ __align__(16) unsigned char smem_rc[];
  const int ld = D + 8, nc = D / kU, n_nt = D / 8;
  const int rank = static_cast<int>(cluster_rank());
  const int u0 = rank * kU;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bf16* hb = reinterpret_cast<bf16*>(smem_rc);  // [2][BB][ld]
  bf16* hst = hb + 2 * BB * ld;                  // [BB][kU]
  float* slot = reinterpret_cast<float*>(smem_rc);  // [nc][BB][kU]
  for (int i = tid; i < 2 * BB * ld + BB * kU; i += kThreads) {
    hb[i] = __float2bfloat16(0.f);
  }
  __syncthreads();
  cl_arrive();
  float keep = 0.f;
  for (int t = 0; t < n_steps; ++t) {
    if (mode == 0) {
      cl_wait();
      for (int i = tid; i < BB * kU; i += kThreads) {
        hst[i] = __float2bfloat16(static_cast<float>(t + i));
      }
      __syncthreads();
      push_h<BB>(hst, hb + ((t & 1) ^ 1) * BB * ld, ld, u0, nc, rank);
      cl_arrive();
    } else if (mode == 2) {
      cl_wait();
      cl_arrive();
    } else {
      float acc[MT][8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = keep + t + e;
      cl_wait();
      push_partials<MT>(acc, slot, rank, n_nt, warp, lane);
      cl_arrive();
      cl_wait();
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float s = 0.f;
        for (int j = 0; j < nc; ++j)
          s += slot[(j * BB + warp + 8 * i) * kU + lane];
        keep += s;
      }
      cl_arrive();
    }
  }
  cl_wait();
  if (tid == 0) {
    out[blockIdx.x] = mode == 0 ? to_f(hb[(n_steps & 1) * BB * ld + u0]) : 0.f;
  }
  if (mode != 0 && keep == -1.f) out[blockIdx.x] = keep;
}

// ------------------------------------------------- B12/B13 bf16 (rc, GRU)
//
// The GRU's cell math rounds every fp32 operation on its own, in the
// Pallas bodies' order (the __f*_rn intrinsics: nvcc contracts none of
// them into an FMA), so that a row's bits do not depend on the tile, the
// m-tile or the fragment half it falls in.

// B12's bf16 recurrence on the resident route: the clusters, tiles and
// warp layout of lstm_cluster_fwd_kernel, CTA `rank` keeping the 96 gate
// columns (u | r | c~) of its units u0 = 32 rank .. u0 + 31 in shared
// memory for all T steps. The reset comes before the candidate's product
// (c~ = tanh(x_c + bf16(r * h) W_c)), so a step has two halves, each a
// product over the whole tile (warp w: the 8 units 8 (w % 4).. over half
// of K, the halves met in shared memory as in the LSTM), an all-gather
// by DSMEM and a cluster barrier:
//   (a) g_ur = x[:, :2D] + h_lp W_ur from the h buffer (the whole bf16
//       h); u, r; the CTA's slice of bf16(r * h) goes to every CTA's rh
//       buffer;
//   (b) c~ = tanh(x_c + rh_lp W_c) from the rh buffer; the blend and the
//       length mask on the fp32 carry, which never leaves its registers;
//       the new h slice goes to every CTA's h buffer.
// One h and one rh buffer suffice, because every CTA arrives at the
// barrier that ends a half only after its last read of that half's
// buffer (its products are consumed before it stages its slice): the h
// pushes of step t follow the (a) -> (b) barrier, which every CTA
// reaches after reading h in (a); the rh pushes of step t + 1 follow the
// (b) -> (a) barrier, which every CTA reaches after reading rh in (b).
// u and r are written between the halves, hs and c~ after the second,
// with the next step's x fetched behind them.
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
    gru_cluster_fwd_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ w,
                           const float* __restrict__ lens,
                           const bf16* __restrict__ h0,
                           bf16* __restrict__ hs, bf16* __restrict__ gates,
                           int n_steps, int B, int D) {
  constexpr int BB = 16 * MT, NG = 3;
  extern __shared__ __align__(16) unsigned char smem_rc[];
  const int ld = D + 8, G = NG * D, nc = D / kU;
  bf16* ws = reinterpret_cast<bf16*>(smem_rc);  // [NG * kU][ld]
  bf16* hb = ws + NG * kU * ld;                 // [BB][ld] h
  bf16* rb = hb + BB * ld;                      // [BB][ld] r * h
  bf16* hst = rb + BB * ld;                     // [BB][kU] a staged slice
  // the K halves' partials, [2][4][MT][NG][32][2]
  float* red = reinterpret_cast<float*>(hst + BB * kU);
  const int rank = static_cast<int>(cluster_rank());
  const int u0 = rank * kU;
  const int b0 = static_cast<int>(blockIdx.x) / nc * BB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ug = warp & 3, kh = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int uc = u0 + 8 * ug + 2 * t4;  // the first unit of a cell pair
  const int rl = g + 8 * kh;            // the cells' row in each m-tile

  load_w_slice<NG>(w, ws, D, u0);
  for (int i = tid; i < BB * (D / 8); i += kThreads) {
    const int r = i / (D / 8), k0 = 8 * (i % (D / 8));
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (b0 + r < B) {
      v = *reinterpret_cast<const uint4*>(
          h0 + static_cast<size_t>(b0 + r) * D + k0);
    }
    *reinterpret_cast<uint4*>(hb + r * ld + k0) = v;
  }
  float hc[MT][2], len[MT], xv[MT][NG][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int b = b0 + 16 * mt + rl;
    const size_t o = static_cast<size_t>(b) * D + uc;
    len[mt] = b < B ? lens[b] : 0.f;
#pragma unroll
    for (int cu = 0; cu < 2; ++cu) hc[mt][cu] = b < B ? to_f(h0[o + cu]) : 0.f;
  }
  if (n_steps > 0) load_xg<MT>(x, xv, 0, B, D, b0 + rl, uc);
  __syncthreads();
  cl_arrive();  // the first wait: every CTA has started, its h0 in place

  // per-lane ldmatrix addresses: A (rows of the h or rh buffer); B, the
  // warp's units of gates u and r (by lane / 16), and of gate c~ (.x2)
  const uint32_t a_lane = static_cast<uint32_t>(
      2 * (((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 8 * (lane >> 4)));
  const uint32_t h_addr = smem_u32(hb) + a_lane;
  const uint32_t rh_addr = smem_u32(rb) + a_lane;
  const uint32_t bur_addr = smem_u32(
      ws + ((lane >> 4) * kU + 8 * ug + (lane & 7)) * ld +
      8 * ((lane >> 3) & 1));
  const uint32_t bc_addr = smem_u32(
      ws + (2 * kU + 8 * ug + (lane & 7)) * ld + 8 * ((lane >> 3) & 1));
  const int kb = kh * (D / 2);
  // this warp's partials for its partner's rows, and the partner's for
  // this one's: [writer's kh][ug][mt][gate][lane] float2
  float* red_out = red + ((kh * 4 + ug) * MT * NG * 32 + lane) * 2;
  const float* red_in =
      red + (((kh ^ 1) * 4 + ug) * MT * NG * 32 + lane) * 2;
  for (int t = 0; t < n_steps; ++t) {
    // (a) g_ur = x[:, :2D] + h_lp W_ur; u, r; bf16(r * h)
    cl_wait();  // h_t is whole in the h buffer
    float acc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][q][e] = 0.f;
    for (int k = kb; k < kb + D / 2; k += 16) {
      uint32_t bq[4];  // gate u (0, 1), gate r (2, 3)
      ldsm_x4(bur_addr + 2 * k, bq);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldsm_x4(h_addr + 2 * (16 * mt * ld + k), a);
        mma_bf16(acc[mt][0], a, bq[0], bq[1]);
        mma_bf16(acc[mt][1], a, bq[2], bq[3]);
      }
    }
    // a fragment's rows g (elements 0, 1) and g + 8 (2, 3): this warp's
    // cells are one pair, its partner's the other
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        *reinterpret_cast<float2*>(red_out + (mt * NG + q) * 32 * 2) =
            kh ? make_float2(acc[mt][q][0], acc[mt][q][1])
               : make_float2(acc[mt][q][2], acc[mt][q][3]);
    __syncthreads();
    float gv[MT][NG][2];  // the activations: [mt][gate][unit]
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float2 p = *reinterpret_cast<const float2*>(
            red_in + (mt * NG + q) * 32 * 2);
        const float m0 = kh ? acc[mt][q][2] : acc[mt][q][0];
        const float m1 = kh ? acc[mt][q][3] : acc[mt][q][1];
        gv[mt][q][0] = sigmoid(__fadd_rn(xv[mt][q][0], __fadd_rn(m0, p.x)));
        gv[mt][q][1] = sigmoid(__fadd_rn(xv[mt][q][1], __fadd_rn(m1, p.y)));
      }
      *reinterpret_cast<uint32_t*>(hst + (16 * mt + rl) * kU + 8 * ug +
                                   2 * t4) =
          f2_to_bf2(__fmul_rn(gv[mt][1][0], hc[mt][0]),
                    __fmul_rn(gv[mt][1][1], hc[mt][1]));
    }
    __syncthreads();  // the rh slice is staged; red is read
    push_h<BB>(hst, rb, ld, u0, nc, rank);
    cl_arrive();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int b = b0 + 16 * mt + rl;
      if (b >= B) continue;
      const size_t row = static_cast<size_t>(t) * B + b;
      store2(gates + row * G + uc, gv[mt][0]);
      store2(gates + row * G + D + uc, gv[mt][1]);
    }
    // (b) c~ = tanh(x_c + rh_lp W_c); the blend under the mask
    cl_wait();  // r * h is whole in the rh buffer
    float acc_c[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_c[mt][e] = 0.f;
    for (int k = kb; k < kb + D / 2; k += 16) {
      uint32_t bc[2];
      ldsm_x2(bc_addr + 2 * k, bc);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldsm_x4(rh_addr + 2 * (16 * mt * ld + k), a);
        mma_bf16(acc_c[mt], a, bc[0], bc[1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      *reinterpret_cast<float2*>(red_out + (mt * NG + 2) * 32 * 2) =
          kh ? make_float2(acc_c[mt][0], acc_c[mt][1])
             : make_float2(acc_c[mt][2], acc_c[mt][3]);
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float m = static_cast<float>(t) < len[mt] ? 1.f : 0.f;
      const float2 p = *reinterpret_cast<const float2*>(
          red_in + (mt * NG + 2) * 32 * 2);
      const float s[2] = {__fadd_rn(kh ? acc_c[mt][2] : acc_c[mt][0], p.x),
                          __fadd_rn(kh ? acc_c[mt][3] : acc_c[mt][1], p.y)};
#pragma unroll
      for (int cu = 0; cu < 2; ++cu) {
        const float u = gv[mt][0][cu], hp = hc[mt][cu];
        const float c = tanhf(__fadd_rn(xv[mt][2][cu], s[cu]));
        const float ht =
            __fadd_rn(__fmul_rn(u, hp), __fmul_rn(__fsub_rn(1.f, u), c));
        gv[mt][2][cu] = c;
        hc[mt][cu] =
            __fadd_rn(__fmul_rn(m, ht), __fmul_rn(__fsub_rn(1.f, m), hp));
      }
      *reinterpret_cast<uint32_t*>(hst + (16 * mt + rl) * kU + 8 * ug +
                                   2 * t4) = f2_to_bf2(hc[mt][0], hc[mt][1]);
    }
    __syncthreads();  // the h slice is staged; red is read
    push_h<BB>(hst, hb, ld, u0, nc, rank);
    cl_arrive();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int b = b0 + 16 * mt + rl;
      if (b >= B) continue;
      const size_t row = static_cast<size_t>(t) * B + b;
      store2(hs + row * D + uc, hc[mt]);
      store2(gates + row * G + 2 * D + uc, gv[mt][2]);
    }
    if (t + 1 < n_steps) load_xg<MT>(x, xv, t + 1, B, D, b0 + rl, uc);
  }
  cl_wait();  // no CTA writes into this one's shared memory any more
}

// the GRU reverse's inputs of step t for this thread's cells (rows row0
// + 16 i, units gu, gu + 1): the three saved gates, h_prev as stored (h0
// at t = 0) and dhs, four bytes a load
template <int MT>
__device__ __forceinline__ void load_gru_bwd(
    const bf16* __restrict__ gates, const bf16* __restrict__ hs,
    const bf16* __restrict__ h0, const bf16* __restrict__ dhs,
    float (&gq)[MT][3][2], float (&hp)[MT][2], float (&dhv)[MT][2], int t,
    int B, int D, int row0, int gu) {
  const int G = 3 * D;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int b = row0 + 16 * i;
    if (b >= B) {
#pragma unroll
      for (int cu = 0; cu < 2; ++cu) {
        gq[i][0][cu] = gq[i][1][cu] = gq[i][2][cu] = 0.f;
        hp[i][cu] = dhv[i][cu] = 0.f;
      }
      continue;
    }
    const size_t n = static_cast<size_t>(t) * B + b;
#pragma unroll
    for (int q = 0; q < 3; ++q) load2(gates + n * G + q * D + gu, gq[i][q]);
    load2(t > 0 ? hs + (n - B) * D + gu : h0 + static_cast<size_t>(b) * D + gu,
          hp[i]);
    load2(dhs + n * D + gu, dhv[i]);
  }
}

// B13's bf16 reverse recurrence on the resident route; the clusters,
// tiles and W slices of gru_cluster_fwd_kernel, the thread layout of
// lstm_cluster_bwd_kernel (thread (warp, lane) owns the cells of rows 2
// warp + lane / 16 + 16 i, units u0 + 2 (lane % 16) and the next). Per
// step, in reverse:
//   (1) the owners form du_pre and dc_pre from their fp32 carry dh and
//       the step's inputs (fetched a step ahead), write them to dx and,
//       in bf16, to the dgates tile [BB][du | dr | dc~];
//   (2) the partial drh = dc_lp[:, own 32] W_c_slice^T over all D
//       (slice_t_product: the resident slice read by ldmatrix.trans) is
//       reduce-scattered to the columns' owners (DSMEM, one slot per
//       sender), which sum the slots in rank order and form dr_pre;
//   (3) the partial dur_lp[:, own 64] W_ur_slice^T is reduce-scattered
//       the same way, and dh_prev = dh_t u + drh r + dur_lp W_ur^T + (1 -
//       m) dH in that order (the Pallas body's).
// One set of slots serves both reductions: each push waits on the
// barrier every owner arrives at after it has summed the slots before,
// so a step takes four barrier phases. dx keeps the JAX layout
// [du_pre | dr_pre | dc_pre] that gru_dw reads.
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
    gru_cluster_bwd_kernel(const bf16* __restrict__ gates,
                           const bf16* __restrict__ hs,
                           const bf16* __restrict__ w,
                           const float* __restrict__ lens,
                           const bf16* __restrict__ h0,
                           const bf16* __restrict__ dhs,
                           bf16* __restrict__ dx, bf16* __restrict__ dh0,
                           int n_steps, int B, int D) {
  constexpr int BB = 16 * MT, NG = 3, LDG = NG * kU + 8;
  extern __shared__ __align__(16) unsigned char smem_rc[];
  const int ld = D + 8, G = NG * D, nc = D / kU, n_nt = D / 8;
  bf16* ws = reinterpret_cast<bf16*>(smem_rc);
  bf16* dg = ws + NG * kU * ld;                          // [BB][LDG]
  float* slot = reinterpret_cast<float*>(dg + BB * LDG);  // [nc][BB][kU]
  const int rank = static_cast<int>(cluster_rank());
  const int u0 = rank * kU;
  const int b0 = static_cast<int>(blockIdx.x) / nc * BB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int up = 2 * (lane & 15);        // the cells' first local unit
  const int gu = u0 + up;
  const int r0 = 2 * warp + (lane >> 4);  // their row in each 16 rows

  load_w_slice<NG>(w, ws, D, u0);
  float dh[MT][2], len[MT], gq[MT][3][2], hp[MT][2], dhv[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int b = b0 + r0 + 16 * i;
    len[i] = b < B ? lens[b] : 0.f;
    dh[i][0] = dh[i][1] = 0.f;
  }
  if (n_steps > 0) {
    load_gru_bwd<MT>(gates, hs, h0, dhs, gq, hp, dhv, n_steps - 1, B, D,
                     b0 + r0, gu);
  }
  __syncthreads();
  cl_arrive();  // pairs with the first step's wait before its stores

  const uint32_t a_addr = smem_u32(
      dg + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDG + 8 * (lane >> 4));
  const uint32_t b_addr = smem_u32(ws + (lane & 15) * ld);
  for (int t = n_steps - 1; t >= 0; --t) {
    // (1) du_pre, dc_pre
    float dht[MT][2], keep[MT][2], part[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = r0 + 16 * i, b = b0 + r;
      const float m = static_cast<float>(t) < len[i] ? 1.f : 0.f;
      float du[2], dc[2];
#pragma unroll
      for (int cu = 0; cu < 2; ++cu) {
        const float u = gq[i][0][cu], c = gq[i][2][cu];
        const float dH = __fadd_rn(dhv[i][cu], dh[i][cu]);
        dht[i][cu] = __fmul_rn(m, dH);
        keep[i][cu] = __fmul_rn(__fsub_rn(1.f, m), dH);
        const float dhu = __fmul_rn(dht[i][cu], __fsub_rn(hp[i][cu], c));
        du[cu] = __fmul_rn(__fmul_rn(dhu, u), __fsub_rn(1.f, u));
        dc[cu] = __fmul_rn(__fmul_rn(dht[i][cu], __fsub_rn(1.f, u)),
                           __fsub_rn(1.f, __fmul_rn(c, c)));
      }
      if (b < B) {
        const size_t n = static_cast<size_t>(t) * B + b;
        store2(dx + n * G + gu, du);
        store2(dx + n * G + 2 * D + gu, dc);
      }
      // padding rows: zeros (their inputs are)
      *reinterpret_cast<uint32_t*>(dg + r * LDG + up) = f2_to_bf2(du[0], du[1]);
      *reinterpret_cast<uint32_t*>(dg + r * LDG + 2 * kU + up) =
          f2_to_bf2(dc[0], dc[1]);
    }
    __syncthreads();  // the dc~ columns of the tile are whole
    // (2) drh: the partial product, reduce-scatter, the owners' sums
    float acc[MT][8][4];
    slice_t_product<MT, 2 * kU, 3 * kU, LDG>(acc, a_addr, b_addr, ld, n_nt,
                                             warp, lane, rank);
    cl_wait();  // every owner has summed the slots of the reduction before
    push_partials<MT>(acc, slot, rank, n_nt, warp, lane);
    cl_arrive();
    cl_wait();  // every partial is in its owner's slots
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = r0 + 16 * i, b = b0 + r;
      float drh[2] = {0.f, 0.f}, dr[2];
      for (int j = 0; j < nc; ++j) {
        const float2 v =
            *reinterpret_cast<const float2*>(slot + (j * BB + r) * kU + up);
        drh[0] += v.x;
        drh[1] += v.y;
      }
#pragma unroll
      for (int cu = 0; cu < 2; ++cu) {
        const float rg = gq[i][1][cu];
        dr[cu] = __fmul_rn(__fmul_rn(__fmul_rn(drh[cu], hp[i][cu]), rg),
                           __fsub_rn(1.f, rg));
        part[i][cu] = __fadd_rn(__fmul_rn(dht[i][cu], gq[i][0][cu]),
                                __fmul_rn(drh[cu], rg));
      }
      if (b < B) {
        store2(dx + (static_cast<size_t>(t) * B + b) * G + D + gu, dr);
      }
      *reinterpret_cast<uint32_t*>(dg + r * LDG + kU + up) =
          f2_to_bf2(dr[0], dr[1]);
    }
    cl_arrive();
    __syncthreads();  // the du | dr columns of the tile are whole
    // (3) dur_lp W_ur^T: the partial product, reduce-scatter, dh_prev
    slice_t_product<MT, 0, 2 * kU, LDG>(acc, a_addr, b_addr, ld, n_nt, warp,
                                        lane, rank);
    cl_wait();  // every owner has summed the drh slots
    push_partials<MT>(acc, slot, rank, n_nt, warp, lane);
    cl_arrive();
    if (t > 0) {  // the next step's inputs, in flight across the barrier
      load_gru_bwd<MT>(gates, hs, h0, dhs, gq, hp, dhv, t - 1, B, D,
                       b0 + r0, gu);
    }
    cl_wait();  // every partial is in its owner's slots
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = r0 + 16 * i;
      float s[2] = {0.f, 0.f};
      for (int j = 0; j < nc; ++j) {
        const float2 v =
            *reinterpret_cast<const float2*>(slot + (j * BB + r) * kU + up);
        s[0] += v.x;
        s[1] += v.y;
      }
      dh[i][0] = __fadd_rn(__fadd_rn(part[i][0], s[0]), keep[i][0]);
      dh[i][1] = __fadd_rn(__fadd_rn(part[i][1], s[1]), keep[i][1]);
    }
    cl_arrive();
  }
  cl_wait();  // no CTA writes into this one's shared memory any more
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int b = b0 + r0 + 16 * i;
    if (b < B) store2(dh0 + static_cast<size_t>(b) * D + gu, dh[i]);
  }
}

// C [M][N] = A [M][K] B (+ bias[N]): the route's two GEMMs, bf16 operands
// read as they lie, fp32 sums on wgmma, no copy or transpose. Mode 0, the
// pre-pass (lstm_xg_kernel): A = xe, B = Wx [K][N] (MN-major), fp32 out
// plus the bias after the full K sum. Mode 1, the post-pass
// (lstm_dxe_kernel): A = dx, B = Wx [N][K] read as B^T (K-major), bf16
// out. What bounds them at the flagship's shapes (T*B = 12,800, D 512):
// the pre-pass writes 105 MB of fp32 (bytes); the post-pass reads dx's
// 52 MB, and at E 512 does 27 GFLOP (0.027 ms at 989 TFLOP/s).
// The design: one persistent block an SM, in clusters of two (CM). A
// cluster walks cluster tiles (CM row tiles sharing one column tile of
// BN columns: 128 in mode 0 and where N <= 128, else 256); each block
// loads its own A and 1/CM of B, multicast to the cluster, so B's L2
// reads fall by CM. A row tile is two halves of op.rows <= 64 rows, each
// in the place of a 64-row m64 operand (the rows past op.rows are
// computed and never stored); the launch takes as few rows as keep the
// rounds that 128-row tiles would take, so the last round is not left
// part empty (the post-pass at T*B = 12,800 on 66 clusters: 49-row
// halves, every SM busy, where 128-row tiles left 32 idle). In a block
// one producer warp fills a ring of 64-deep K stages by TMA (128-byte
// swizzle; rows and columns past the bounds load as zeros) for two
// consumer warpgroups that run wgmma m64nBNk16 from the landed stages,
// one group in flight behind the next, with a full and an empty mbarrier
// a stage (empty: every consuming warpgroup of every block releases it,
// since every block's producer writes it). The epilogue stages 64 columns a pass in shared
// memory, in the 128-byte swizzle (conflict-free), and stores each pass
// by TMA, the stores draining while the next products run.
//   - Mode 1 (bf16 out) is cooperative: each warpgroup takes one half of
//     every tile and stages two buffers deep.
//   - Mode 0 (fp32 out, 105 MB at the flagship: write-bound) is
//     ping-pong: each warpgroup takes every other tile whole (both
//     halves, two m64 products a k-step), so one writes its tile out
//     while the other's products run; they wait for stages in turn (a
//     tile each) so that no stage is awaited a ring phase early.
// Sums run in a fixed order, the same for any op.rows: two launches give
// the same bits.
struct ProjOps {
  const bf16* bias;  // mode 0: [N]
  int M, N, K;
  int rows;   // a half tile's rows, <= 64
  int n_col;  // column tiles
  int tiles;  // cluster tiles (CM row tiles) x column tiles
};

// the tensor maps: a [M][K] in 64 x op.rows boxes; b [K][N] in 64 x 64
// boxes (mode 0: one 64-column slice of a stage), or [N][K] in 64 x BN/CM
// boxes (mode 1: a block's part of the stage); out [M][N] in boxes of
// 128 bytes x op.rows
struct ProjMaps {
  CUtensorMap a, b, out;
};

// kPre: mode 0 (ping-pong), else mode 1 (cooperative)
template <int BN, bool kPre>
struct ProjCfg {
  static constexpr int kBK = 64;                 // K a stage
  static constexpr int kABytes = tc::kBM * 128;  // 2 x 64 rows of 64 K
  static constexpr int kStageBytes = kABytes + BN * 128;
  static constexpr int kOutSize = kPre ? 4 : 2;
  static constexpr int kBoxCols = 128 / kOutSize;  // an output box's
  static constexpr int kBoxBytes = 64 * 128;
  // the epilogue: a warpgroup stages kEpiCols columns a pass in one of
  // kStgBufs buffers, each pass's TMA store draining while the next
  // passes are written (ping-pong: the other warpgroup's products hide it)
  static constexpr int kEpiCols = 64;
  static constexpr int kStgBufs = kPre ? 1 : 2;
  static constexpr int kEpiBoxes = kEpiCols / kBoxCols;
  static constexpr int kPasses = BN / kEpiCols;
  // a warpgroup's halves of a tile: both (ping-pong) or one
  static constexpr int kHalves = kPre ? 2 : 1;
  static constexpr int kBufBytes = kEpiBoxes * kBoxBytes * kHalves;
  static constexpr int kStgBytes = kStgBufs * kBufBytes;  // a warpgroup's
  // what is left of 226 KiB (227 less the barriers) for the ring, <= 6
  static constexpr int kRing = 226 * 1024 - 1024 - 2 * kStgBytes;
  static constexpr int kStages =
      kRing / kStageBytes < 6 ? kRing / kStageBytes : 6;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStgBytes + 1024;
  static_assert(kStages > 1, "a stage to load while they run");
};

template <int BN, int CM, bool kPre>
__device__ __forceinline__ void proj_gemm(const ProjOps& op,
                                          const ProjMaps& maps) {
  using C = ProjCfg<BN, kPre>;
  constexpr int kS = C::kStages;
  static_assert(kPre ? BN / 64 % CM == 0 : BN % (8 * CM) == 0,
                "each block of a cluster loads an equal part of B");
  extern __shared__ uint8_t pg_smem[];
  // full, then empty, then (ping-pong) each warpgroup's turn
  __shared__ __align__(8) uint64_t bars[2 * kS + 2];
  const uint32_t raw = smem_u32(pg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = pg_smem + (base - raw);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kS;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int rank = tc::cluster_rank();
  const int cid = static_cast<int>(blockIdx.x) / CM;
  const int n_cl = static_cast<int>(gridDim.x) / CM;
  const int n_k = (op.K + C::kBK - 1) / C::kBK;
  const int rows = op.rows;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      tc::mbar_init(full0 + 8 * s, 1);
      // every consumer warpgroup of every block (ping-pong: one of each)
      tc::mbar_init(empty0 + 8 * s, (kPre ? 1 : 2) * CM);
    }
    tc::mbar_init(empty0 + 8 * kS, 1);
    tc::mbar_init(empty0 + 8 * kS + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  tc::cluster_sync();

  if (wg == 2) {  // ---- the producer warp
    int it = 0;   // stages filled, over every tile
    for (int t = cid; t < op.tiles; t += n_cl) {
      const int m0 = (CM * (t / op.n_col) + rank) * 2 * rows;
      const int n0 = (t % op.n_col) * BN;
      for (int kb = 0; kb < n_k; ++kb, ++it) {
        const int s = it % kS;
        if (it >= kS) tc::mbar_wait(empty0 + 8 * s, (it / kS - 1) & 1);
        if (lane == 0) {
          const uint32_t st = base + s * C::kStageBytes, full = full0 + 8 * s;
          const uint32_t b = st + C::kABytes;
          tc::mbar_expect_tx(full, (2 * rows + BN) * 128, false);
          tc::tma_load(st, &maps.a, kb * C::kBK, m0, full);
          tc::tma_load(st + 8192, &maps.a, kb * C::kBK, m0 + rows, full);
          if (kPre) {
            constexpr int kPer = BN / 64 / CM;  // slices a block loads
            for (int j = rank * kPer; j < (rank + 1) * kPer; ++j) {
              tc::tma_load(b + j * 8192, &maps.b, n0 + 64 * j, kb * C::kBK,
                           full, CM);
            }
          } else {
            tc::tma_load(b + rank * BN / CM * 128, &maps.b, kb * C::kBK,
                         n0 + rank * BN / CM, full, CM);
          }
        }
      }
    }
  } else if constexpr (kPre) {  // ---- ping-pong: warpgroup wg takes the
    // block's tiles wg, wg + 2, ...: both halves, so one warpgroup's
    // epilogue runs while the other's products do. The two wait for
    // stages in turn, a tile each (turn: the other's last stage of its
    // tile has landed), so no stage is awaited a phase early. (Written
    // out on its own: with its declarations and stage release shared
    // with mode 1's, ptxas serialized this loop's wgmma (C7515), 0.062 ->
    // 0.080 ms at E 512 on an H100.)
    const int wtid = tid & 127;
    const bool issuer = wtid == 0;
    const int r0 = 16 * (wtid >> 5) + (lane >> 2);  // and r0 + 8
    const uint32_t stg = base + kS * C::kStageBytes + wg * C::kStgBytes;
    uint8_t* const gstg = gbase + (stg - base);
    float acc[2][BN / 2];  // the two halves
    for (int j = wg, t = cid + wg * n_cl; t < op.tiles;
         j += 2, t += 2 * n_cl) {
      const int m0 = (CM * (t / op.n_col) + rank) * 2 * rows;
      const int n0 = (t % op.n_col) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[0][i] = acc[1][i] = 0.f;
      const uint32_t turn = empty0 + 8 * kS;  // turn + 8 wg: wg's turn
      if (j > 0) tc::mbar_wait(turn + 8 * wg, ((j >> 1) - 1 + wg) & 1);
      for (int kb = 0; kb < n_k; ++kb) {
        const int it = j * n_k + kb, s = it % kS;
        const uint32_t st = base + s * C::kStageBytes, b = st + C::kABytes;
        tc::mbar_wait(full0 + 8 * s, (it / kS) & 1);
        if (kb == n_k - 1 && issuer) tc::mbar_arrive_at(turn + 8 - 8 * wg,
                                                        rank);
        tc::wg_fence();
#pragma unroll
        for (int k = 0; k < C::kBK / 16; ++k) {
          const uint64_t db = tc::desc(b + 2048 * k, 8192, 1024);
          tc::mma<0, 1>(acc[0], tc::desc(st + 32 * k, 16, 1024), db);
          tc::mma<0, 1>(acc[1], tc::desc(st + 8192 + 32 * k, 16, 1024), db);
        }
        tc::wg_commit();
        tc::wg_wait<1>();  // the stage before this one is done
        if (kb > 0 && issuer) {
          for (int r = 0; r < CM; ++r) {
            tc::mbar_arrive_at(empty0 + 8 * ((it - 1) % kS), r);
          }
        }
      }
      tc::wg_wait<0>();
      tc::fence_regs(acc[0]);
      tc::fence_regs(acc[1]);
      if (issuer) {
        for (int r = 0; r < CM; ++r) {
          tc::mbar_arrive_at(empty0 + 8 * ((j * n_k + n_k - 1) % kS), r);
        }
      }
      if (m0 >= op.M) continue;  // a cluster tile's rows past M
      // accumulator 4j + 2h + e: row r0 + 8h, column 8j + 2 (lane % 4) + e
#pragma unroll
      for (int p = 0; p < C::kPasses; ++p) {
        if (issuer) tc::bulk_wait_read<0>();  // the staging is free
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
        for (int jj = 0; jj < C::kEpiCols / 8; ++jj) {
          const int jc = p * C::kEpiCols / 8 + jj;
          const int cl = 8 * jj + 2 * (lane & 3);
          const int cb = cl % C::kBoxCols;
          float2 bv = make_float2(0.f, 0.f);
          const int col = n0 + p * C::kEpiCols + cl;
          if (col < op.N) {
            bv = bf2_to_f2(
                __ldg(reinterpret_cast<const unsigned*>(op.bias + col)));
          }
#pragma unroll
          for (int hm = 0; hm < 2; ++hm) {  // the half
            uint8_t* const box = gstg + (hm * C::kEpiBoxes +
                                         cl / C::kBoxCols) * C::kBoxBytes;
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // (xe_t Wx) + b, as the Pallas sum
              const int r = r0 + 8 * h;
              const float v0 = acc[hm][4 * jc + 2 * h];
              const float v1 = acc[hm][4 * jc + 2 * h + 1];
              *reinterpret_cast<float2*>(
                  box + r * 128 + (((cb >> 2) ^ (r & 7)) << 4) +
                  (cb & 3) * 4) = make_float2(v0 + bv.x, v1 + bv.y);
            }
          }
        }
        tc::fence_async();  // the staging's writes, seen by TMA
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        if (issuer) {
          for (int hm = 0; hm < 2; ++hm) {
            for (int x = 0; x < C::kEpiBoxes; ++x) {
              tc::tma_store(&maps.out,
                            stg + (hm * C::kEpiBoxes + x) * C::kBoxBytes,
                            n0 + p * C::kEpiCols + x * C::kBoxCols,
                            m0 + rows * hm);
            }
          }
          tc::bulk_commit();
        }
      }
    }
    if (issuer) tc::bulk_wait<0>();
  } else {  // ---- cooperative: warpgroup wg takes half wg of every tile
    const int wtid = tid & 127;
    const bool issuer = wtid == 0;
    const int r0 = 16 * (wtid >> 5) + (lane >> 2);  // and r0 + 8
    const uint32_t stg = base + kS * C::kStageBytes + wg * C::kStgBytes;
    uint8_t* const gstg = gbase + (stg - base);
    auto release = [&](int s) {  // stage s, to every block's producer
      if (issuer) {
        for (int r = 0; r < CM; ++r) tc::mbar_arrive_at(empty0 + 8 * s, r);
      }
    };
    float acc[BN / 2];
    int it = 0, ep = 0;  // stages consumed, epilogue passes
    for (int t = cid; t < op.tiles; t += n_cl) {
      const int m0 = (CM * (t / op.n_col) + rank) * 2 * rows + rows * wg;
      const int n0 = (t % op.n_col) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kb = 0; kb < n_k; ++kb, ++it) {
        const int s = it % kS;
        const uint32_t st = base + s * C::kStageBytes;
        const uint32_t a = st + wg * 8192, b = st + C::kABytes;
        tc::mbar_wait(full0 + 8 * s, (it / kS) & 1);
        tc::wg_fence();
#pragma unroll
        for (int k = 0; k < C::kBK / 16; ++k) {
          tc::mma<0, 0>(acc, tc::desc(a + 32 * k, 16, 1024),
                        tc::desc(b + 32 * k, 16, 1024));
        }
        tc::wg_commit();
        tc::wg_wait<1>();  // the stage before this one is done
        if (kb > 0) release((it - 1) % kS);
      }
      tc::wg_wait<0>();
      tc::fence_regs(acc);
      release((it - 1) % kS);
      if (m0 >= op.M) continue;  // a cluster tile's rows past M
      // accumulator 4j + 2h + e: row r0 + 8h, column 8j + 2 (lane % 4) + e
#pragma unroll
      for (int p = 0; p < C::kPasses; ++p, ++ep) {
        const int off = ep % C::kStgBufs * C::kBufBytes;
        if (issuer) tc::bulk_wait_read<C::kStgBufs - 1>();  // buffer free
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
        for (int jj = 0; jj < C::kEpiCols / 8; ++jj) {
          const int j = p * C::kEpiCols / 8 + jj;
          const int cl = 8 * jj + 2 * (lane & 3);
          const int cb = cl % C::kBoxCols;
          uint8_t* const box = gstg + off + cl / C::kBoxCols * C::kBoxBytes;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            *reinterpret_cast<unsigned*>(
                box + r * 128 + (((cb >> 3) ^ (r & 7)) << 4) +
                (cb & 7) * 2) = f2_to_bf2(acc[4 * j + 2 * h],
                                          acc[4 * j + 2 * h + 1]);
          }
        }
        tc::fence_async();  // the staging's writes, seen by TMA
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        if (issuer) {
          for (int x = 0; x < C::kEpiBoxes; ++x) {
            tc::tma_store(&maps.out, stg + off + x * C::kBoxBytes,
                          n0 + p * C::kEpiCols + x * C::kBoxCols, m0);
          }
          tc::bulk_commit();
        }
      }
    }
    if (issuer) tc::bulk_wait<0>();
  }
  tc::cluster_sync();  // no block leaves while its peer may still signal it
}

// xg [M = T*B][G] fp32 = xe [M][E] @ wx [E][G] + b
template <int BN, int CM>
__global__ void __launch_bounds__(288, 1)
    lstm_xg_kernel(const ProjOps op, const __grid_constant__ ProjMaps maps) {
  proj_gemm<BN, CM, true>(op, maps);
}

// dxe [M][E] bf16 = dx [M][G] @ wx^T (wx [E][G] read as B^T)
template <int BN, int CM>
__global__ void __launch_bounds__(288, 1)
    lstm_dxe_kernel(const ProjOps op, const __grid_constant__ ProjMaps maps) {
  proj_gemm<BN, CM, false>(op, maps);
}

// ------------------- B10/B11, B14/B15 bf16 past D 512: the grid route
//
// Past D 512 the 4D columns of W no longer fit one 16-CTA cluster's shared
// memory (8 MiB at D 1024, 12.5 MiB at D 1280, against some 3.6 MB), and
// the streaming kernels read all of W from L2 at every step (240-360 us a
// step at D 1024, T 100, B 128 on an H100). The grid route keeps W
// resident across a group of D / 256 clusters of 16 CTAs, all resident
// at once (D 1024: 64 CTAs, D 1280: 80), each CTA holding 16 hidden
// units' share of W in shared memory for all T steps. A step's exchange
// crosses clusters through L2, ordered by one group barrier a step
// (group_sync: every CTA arrives on a step counter in global memory,
// release at gpu scope, and spins on an acquire load of it). The group fills most of the card, so one group
// does every batch row: the rows loop inside the step in tiles of 128
// (no wave of groups repeats the T-step chain), and the step's [B, D]
// operand streams through shared memory in K chunks of 64 (cp.async.cg
// from L2, three stages), since it does not fit beside W's share.
//   lstm_grid_fwd_kernel, B14's recurrence (xg fp32; with lstm_xg_kernel it
//     replaces paddle_tpu/kernels/fused_rnn.py:663, _lstm_proj_fwd_call's
//     _lstm_proj_fwd_kernel) and B10 (x bf16; :215, _lstm_fwd_call's
//     _lstm_fwd_kernel) at these D: CTA i owns units 16 i..16 i + 15 and keeps
//     their 64 gate columns [64][D + 8] (load_w_slice). A step multiplies
//     h_{t-1} (hs[t - 1], or h0: the stored bf16 h is the product's operand)
//     by them on the tensor cores (mma.sync m16n8k16, fp32 sums over K in
//     order): warp (mg, ug) takes rows 16 mg and 16 mg + 64 of the tile and
//     the four gates of units 8 ug.., so each thread holds all four gates of
//     its cells and no partial crosses warps. The cell (__f*_rn, as the GRU's)
//     writes hs[t], cs[t], gates[t] and the fp32 carries. hs[t] is fresh
//     memory every step, so no buffer is reused across steps and one barrier a
//     step orders every read after every write.
//   lstm_grid_bwd_kernel, B15's recurrence (with db; with lstm_dxe_kernel it
//     replaces paddle_tpu/kernels/fused_rnn.py:700, _lstm_proj_bwd_call's
//     _lstm_proj_bwd_kernel, all but dW) and B11's (without db; :266,
//     _lstm_bwd_call's _lstm_bwd_kernel, all but dW) at these D: dh_prev =
//     dgates_lp W^T sums over all 4D gate columns, which column slices would
//     turn into an all-to-all of fp32 [B, D] partials (512 KB a CTA a step at
//     B 128, D 1024). Instead the K of that product is split by cluster and
//     its N by rank: cluster c owns the units of its CTAs, CTA (c, j) the 16
//     units 16 NCL j + 16 c.. (NCL = D / 256, the group's clusters), so a
//     cluster's 1024 gate columns are its CTAs' dgates; CTA (c, j) keeps W's
//     rows 16 NCL j .. 16 NCL (j + 1) - 1 over those columns, [16 NCL][1024 +
//     8], read from W as it lies (no transposed copy). A step: each CTA's
//     cells write their dgates (dx[t], bf16: the rounded operand of the
//     product); a cluster barrier; each CTA multiplies the cluster's dgates
//     (read from L2 in K chunks, as the forward reads h) by its rows: cluster
//     c's share of dh_prev at the units of rank j, fp32 [B, 16 NCL], into
//     global slots [2][NCL][B][D]; the group barrier; each CTA sums the NCL
//     clusters' slots at its own units in cluster order (fixed: two launches
//     give the same bits) at the start of the next step's cells. The slots are
//     double-buffered by step parity: a slot of parity p is written again two
//     steps later, after the barrier that follows every reader.
//     db (B15): each thread sums its cells' unrounded dgates over its rows
//     and steps; the 32 threads of a unit pair are summed in thread order
//     at the end, and each CTA writes db at its own units.
//   The fp32 carries (h, c; the backward's (1 - m) dH and dc) live in
//   global scratch [2][B][D], each element read and written only by the
//   thread of its cell. Scratch (carries, slots, the step counter, zeroed
//   for each launch) is the wrapper's. The launch refuses a group that the
//   card cannot hold at once (cudaOccupancyMaxActiveClusters, and the
//   cooperative launch attribute beside the cluster dimension), and a
//   spin that waits longer than kSpinNs traps, which fails the stream: no
//   CTA waits on a cluster that is not resident, and none carries on past
//   one.
// What bounds them: the card's least time for a whole call is its operations
// (B10 at T 100, B 128, D 1024: 107 GFLOP, 0.109 ms at 989 TFLOP/s, against
// 0.27 GB in 0.081 ms), but a step cannot start before the one before it ends,
// so the chain of T steps sets the time: a step's product is 2 B D 64 FLOP a
// CTA (17 MFLOP at B 128, D 1024) on mma.sync, its operand 2 B D bytes a CTA
// from L2 (256 KB; 16 MB for the group), and the group barrier. The design
// keeps W out of that chain (resident), stages the operand in three K chunks
// so its L2 reads overlap the product, and has one barrier a step; the operand
// is read once a CTA, not multicast to the cluster (a TMA multicast would cut
// the group's L2 reads 16-fold, at the price of a cluster-wide handshake per
// stage).
constexpr int kGU = 16;             // hidden units a CTA of the grid route owns
constexpr int kGN = 4 * kGU;        // the forward's gate columns of them
constexpr int kGCl = 16;            // CTAs a cluster
constexpr int kGRows = 128;         // batch rows a row tile
constexpr int kGK = 64;             // K of a staged chunk
constexpr int kGStages = 3;
constexpr int kGLd = kGK + 8;       // row stride of a staged chunk (bf16)
constexpr int kGBwdK = kGN * kGCl;  // the backward's K: a cluster's columns
constexpr int kGStage = kGRows * kGLd;
constexpr unsigned long long kSpinNs = 4000000000ull;

// shared memory of the grid route's CTAs: the forward's W columns [64][D +
// 8] or the backward's W rows [D / 16][1024 + 8], then the staged chunks
// [3][128][72], all bf16
constexpr int grid_fwd_smem(int D) {
  return 2 * (kGN * (D + 8) + kGStages * kGStage);
}
constexpr int grid_bwd_smem(int D) {
  return 2 * ((D / kGCl) * (kGBwdK + 8) + kGStages * kGStage);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// the group barrier: every CTA of the launch arrives before any leaves,
// and what any of them wrote to global memory before it is seen by all of
// them after it. Each CTA arrives on the counter itself (release at gpu
// scope after its threads' writes, a spin on an acquire load), as a
// cooperative grid sync does: barrier s (from 1) waits for s x the
// launch's CTAs arrivals.
__device__ __forceinline__ void group_sync(unsigned* counter,
                                           unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter)
                 : "memory");
    const unsigned long long t0 = global_ns();
    for (;;) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(counter)
                   : "memory");
      if (v >= target) break;
      if (global_ns() - t0 > kSpinNs) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// the cell of rc::cell with every fp32 operation rounded on its own
__device__ __forceinline__ void cell_rn(float p0, float p1, float p2, float p3,
                                        float m, float& hp, float& cp,
                                        float& g0, float& g1, float& g2,
                                        float& g3) {
  g0 = sigmoid(p0);
  g1 = sigmoid(p1);
  g2 = tanhf(p2);
  g3 = sigmoid(p3);
  const float ct = __fadd_rn(__fmul_rn(g1, cp), __fmul_rn(g0, g2));
  const float ht = __fmul_rn(g3, tanhf(ct));
  const float keep = __fsub_rn(1.f, m);
  hp = __fadd_rn(__fmul_rn(m, ht), __fmul_rn(keep, hp));
  cp = __fadd_rn(__fmul_rn(m, ct), __fmul_rn(keep, cp));
}

// K chunk c % nkc of row tile c / nkc of a [rows][ld_src] operand of
// type E (bf16, or fp32 in the fp32 lane), 16 bytes (kV elements) at
// columns col(kc, p) for p < 64 / kV, into stage c % 3 ([128][64 + kV]:
// kGLd for bf16, kFLd for fp32); rows past B read as zeros. One commit
// group per call, empty past nch.
template <typename E, typename Col>
__device__ __forceinline__ void grid_issue(uint32_t st0, const E* src,
                                           size_t ld_src, int B, int c,
                                           int nkc, int nch, Col col) {
  constexpr int kV = 16 / sizeof(E), kLd = kGK + kV, kE = sizeof(E);
  if (c < nch) {
    const int r0 = c / nkc * kGRows, kc = c % nkc;
    const uint32_t dst = st0 + kE * (c % kGStages) * kGRows * kLd;
    for (int i = threadIdx.x; i < kGRows * (kGK / kV); i += kThreads) {
      const int r = i / (kGK / kV), p = i % (kGK / kV), b = r0 + r;
      cp16(dst + kE * (r * kLd + kV * p),
           src + static_cast<size_t>(b < B ? b : 0) * ld_src + col(kc, p),
           b < B);
    }
  }
  cp_commit();
}

// dh at the cell pair at offset o of a [B][D] plane: the keep term
// kcar[o] ((1 - m) dH of the step before) plus the NCL clusters' slots of
// parity par (their shares of dgates W^T), summed in cluster order
template <int NCL>
__device__ __forceinline__ void dh_sum(const float* kcar, const float* slots,
                                       size_t plane, size_t o, int par,
                                       float (&dh)[2]) {
  const float2 k = __ldcg(reinterpret_cast<const float2*>(kcar + o));
  float2 v[NCL];
#pragma unroll
  for (int c = 0; c < NCL; ++c)
    v[c] = __ldcg(reinterpret_cast<const float2*>(
        slots + (static_cast<size_t>(par) * NCL + c) * plane + o));
  float s0 = v[0].x, s1 = v[0].y;
#pragma unroll
  for (int c = 1; c < NCL; ++c) {
    s0 = __fadd_rn(s0, v[c].x);
    s1 = __fadd_rn(s1, v[c].y);
  }
  dh[0] = __fadd_rn(k.x, s0);
  dh[1] = __fadd_rn(k.y, s1);
}

// the reverse cell of cell_rn, every fp32 operation rounded on its own:
// from the saved gates (i, f, c~, o), c_prev, the upstream dH = dhs + dh,
// dC = dcs + dc and the mask m, the four dgates d, the carried dc and the
// keep term (1 - m) dH of the next dh
__device__ __forceinline__ void bwd_cell_rn(float ig, float fg, float gg,
                                            float og, float cp, float dH,
                                            float dC, float m,
                                            float (&d)[4], float& dcn,
                                            float& keep) {
  const float keep_m = __fsub_rn(1.f, m);
  const float tc = tanhf(__fadd_rn(__fmul_rn(fg, cp), __fmul_rn(ig, gg)));
  const float dht = __fmul_rn(m, dH);
  const float dct =
      __fadd_rn(__fmul_rn(m, dC), __fmul_rn(__fmul_rn(dht, og),
                                            __fsub_rn(1.f, __fmul_rn(tc, tc))));
  d[0] = __fmul_rn(__fmul_rn(__fmul_rn(dct, gg), ig), __fsub_rn(1.f, ig));
  d[1] = __fmul_rn(__fmul_rn(__fmul_rn(dct, cp), fg), __fsub_rn(1.f, fg));
  d[2] = __fmul_rn(__fmul_rn(dct, ig), __fsub_rn(1.f, __fmul_rn(gg, gg)));
  d[3] = __fmul_rn(__fmul_rn(__fmul_rn(dht, tc), og), __fsub_rn(1.f, og));
  dcn = __fadd_rn(__fmul_rn(keep_m, dC), __fmul_rn(dct, fg));
  keep = __fmul_rn(keep_m, dH);
}

template <typename XT>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_grid_fwd_kernel(const XT* __restrict__ xg,
                         const bf16* __restrict__ w,
                         const float* __restrict__ lens,
                         const bf16* __restrict__ h0,
                         const bf16* __restrict__ c0, bf16* __restrict__ hs,
                         bf16* __restrict__ cs, bf16* __restrict__ gates,
                         float* __restrict__ carry,
                         unsigned* __restrict__ counter, int n_steps, int B,
                         int D) {
  extern __shared__ __align__(16) unsigned char smem_rc[];
  const int ld = D + 8, G = 4 * D;
  const unsigned ncl = gridDim.x / kGCl;
  bf16* ws = reinterpret_cast<bf16*>(smem_rc);   // [kGN][ld]
  const uint32_t st0 = smem_u32(ws + kGN * ld);  // [kGStages][kGRows][kGLd]
  const int u0 = static_cast<int>(blockIdx.x) * kGU;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ug = warp & 1, mg = warp >> 1, g = lane >> 2, t4 = lane & 3;
  const int uc = u0 + 8 * ug + 2 * t4;  // the cells' first unit
  const int nkc = D / kGK, nch = (B + kGRows - 1) / kGRows * nkc;
  float* hcar = carry;
  float* ccar = carry + static_cast<size_t>(B) * D;

  load_w_slice<4, kGU>(w, ws, D, u0);
  __syncthreads();
  // per-lane ldmatrix addresses: A (the staged rows), B (the W columns of
  // the warp's units, gates q and q + 1 by lane / 16)
  const uint32_t a_lane = static_cast<uint32_t>(
      2 * (((lane & 7) + 8 * ((lane >> 3) & 1)) * kGLd + 8 * (lane >> 4)));
  const uint32_t b_addr =
      smem_u32(ws + ((lane >> 4) * kGU + 8 * ug + (lane & 7)) * ld +
               8 * ((lane >> 3) & 1));
  const auto col = [](int kc, int p) { return kGK * kc + 8 * p; };
  for (int t = 0; t < n_steps; ++t) {
    const bf16* hsrc = t == 0 ? h0 : hs + static_cast<size_t>(t - 1) * B * D;
    grid_issue(st0, hsrc, D, B, 0, nkc, nch, col);
    grid_issue(st0, hsrc, D, B, 1, nkc, nch, col);
    float acc[2][4][4], xv[2][2][4][2], hp[2][2][2], cv[2][2][2], len[2][2];
    for (int c = 0; c < nch; ++c) {
      const int r0 = c / nkc * kGRows, kc = c % nkc;
      if (kc == 0) {  // the row tile's cells: first terms, carries, lengths
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int b = r0 + 16 * (mg + 4 * mt) + g + 8 * hh;
            const bool ok = b < B;
            len[mt][hh] = ok ? lens[b] : 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float2 v =
                  ok ? ld_first(xg + (static_cast<size_t>(t) * B + b) * G +
                                q * D + uc)
                     : make_float2(0.f, 0.f);
              xv[mt][hh][q][0] = v.x;
              xv[mt][hh][q][1] = v.y;
            }
            const size_t o = static_cast<size_t>(ok ? b : 0) * D + uc;
            float2 h = make_float2(0.f, 0.f), cc = h;
            if (ok && t == 0) {
              h = bf2_to_f2(*reinterpret_cast<const unsigned*>(h0 + o));
              cc = bf2_to_f2(*reinterpret_cast<const unsigned*>(c0 + o));
            } else if (ok) {
              h = __ldcg(reinterpret_cast<const float2*>(hcar + o));
              cc = __ldcg(reinterpret_cast<const float2*>(ccar + o));
            }
            hp[mt][hh][0] = h.x;
            hp[mt][hh][1] = h.y;
            cv[mt][hh][0] = cc.x;
            cv[mt][hh][1] = cc.y;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][q][e] = 0.f;
        }
      }
      cp_wait<1>();
      __syncthreads();  // chunk c is in; stage (c + 2) % 3 is free
      grid_issue(st0, hsrc, D, B, c + 2, nkc, nch, col);
      const uint32_t a_base = st0 + 2 * (c % kGStages) * kGStage + a_lane;
#pragma unroll
      for (int ks = 0; ks < kGK / 16; ++ks) {
        const int k = kc * kGK + 16 * ks;
        uint32_t bq[2][4];  // gates 0, 1 and gates 2, 3
        ldsm_x4(b_addr + 2 * k, bq[0]);
        ldsm_x4(b_addr + 2 * (2 * kGU * ld + k), bq[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int m0 = 16 * (mg + 4 * mt);
          if (r0 + m0 >= B) continue;  // no live row in this m-tile
          uint32_t a[4];
          ldsm_x4(a_base + 2 * (m0 * kGLd + 16 * ks), a);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mma_bf16(acc[mt][q], a, bq[q >> 1][2 * (q & 1)],
                     bq[q >> 1][2 * (q & 1) + 1]);
        }
      }
      if (kc != nkc - 1) continue;
      // the cells of the row tile: rows g (elements 0, 1) and g + 8 (2, 3)
      // of each m-tile, units uc, uc + 1
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int b = r0 + 16 * (mg + 4 * mt) + g + 8 * hh;
          const float m = static_cast<float>(t) < len[mt][hh] ? 1.f : 0.f;
          float gv[4][2];
#pragma unroll
          for (int cu = 0; cu < 2; ++cu) {
            float p[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)  // (xe_t Wx + b) + h_lp W
              p[q] = __fadd_rn(xv[mt][hh][q][cu], acc[mt][q][2 * hh + cu]);
            cell_rn(p[0], p[1], p[2], p[3], m, hp[mt][hh][cu],
                    cv[mt][hh][cu], gv[0][cu], gv[1][cu], gv[2][cu],
                    gv[3][cu]);
          }
          if (b >= B) continue;
          const size_t row = static_cast<size_t>(t) * B + b;
          const size_t o = static_cast<size_t>(b) * D + uc;
          store2(hs + row * D + uc, hp[mt][hh]);
          store2(cs + row * D + uc, cv[mt][hh]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            store2(gates + row * G + q * D + uc, gv[q]);
          store2(hcar + o, hp[mt][hh]);
          store2(ccar + o, cv[mt][hh]);
        }
      }
    }
    group_sync(counter, static_cast<unsigned>(t + 1) * ncl * kGCl);
  }
}

template <int NCL, bool kDb>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_grid_bwd_kernel(const bf16* __restrict__ gates,
                         const bf16* __restrict__ cs,
                         const bf16* __restrict__ w,
                         const float* __restrict__ lens,
                         const bf16* __restrict__ c0,
                         const bf16* __restrict__ dhs,
                         const bf16* __restrict__ dcs, bf16* __restrict__ dx,
                         float* __restrict__ db, bf16* __restrict__ dh0,
                         bf16* __restrict__ dc0, float* __restrict__ carry,
                         float* __restrict__ slots,
                         unsigned* __restrict__ counter, int n_steps,
                         int B) {
  constexpr int D = 256 * NCL, G = 4 * D, KB = kGU * NCL, ldw = kGBwdK + 8;
  constexpr int nkc = kGBwdK / kGK;
  extern __shared__ __align__(16) unsigned char smem_rc[];
  bf16* ws = reinterpret_cast<bf16*>(smem_rc);    // [KB][ldw]
  const uint32_t st0 = smem_u32(ws + KB * ldw);  // [kGStages][kGRows][kGLd]
  const int rank = static_cast<int>(cluster_rank());
  const int cl = static_cast<int>(blockIdx.x) / kGCl;
  const int k0 = KB * rank;        // the product's units (W's rows)
  const int own = k0 + kGU * cl;   // the units of this CTA's cells
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mg = warp >> 1, ng = warp & 1, g = lane >> 2, t4 = lane & 3;
  const int up = 2 * (tid & 7), rr = tid >> 3, gu = own + up;
  const int nch = (B + kGRows - 1) / kGRows * nkc;
  const size_t plane = static_cast<size_t>(B) * D;  // a [B][D] fp32 array
  float* kcar = carry;          // (1 - m) dH of the step before
  float* ccar = carry + plane;  // dc

  // ws[o][n] = W[k0 + o][q D + KB j + 16 cl + u], n = 256 q + 16 j + u:
  // the cluster's gate columns (its CTAs' units, rank by rank) in K order
  for (int i = tid; i < KB * (kGBwdK / 8); i += kThreads) {
    const int o = i / (kGBwdK / 8), n = 8 * (i % (kGBwdK / 8));
    const int cw = (n >> 8) * D + KB * ((n >> 4) & 15) + kGU * cl + (n & 15);
    *reinterpret_cast<uint4*>(ws + o * ldw + n) = __ldg(
        reinterpret_cast<const uint4*>(w + static_cast<size_t>(k0 + o) * G +
                                       cw));
  }
  float dbq[4][2];
#pragma unroll
  for (int q = 0; q < 4; ++q) dbq[q][0] = dbq[q][1] = 0.f;
  __syncthreads();
  const uint32_t a_lane = static_cast<uint32_t>(
      2 * (((lane & 7) + 8 * ((lane >> 3) & 1)) * kGLd + 8 * (lane >> 4)));
  const uint32_t b_lane =
      smem_u32(ws + (lane & 7) * ldw + 8 * ((lane >> 3) & 1));
  // the cluster's dgates of K chunk kc, 8 columns p: gate kc / 4, ranks
  // 4 (kc % 4) + p / 2
  const auto col = [cl](int kc, int p) {
    return (kc >> 2) * D + KB * (4 * (kc & 3) + (p >> 1)) + kGU * cl +
           8 * (p & 1);
  };
  // dh at this thread's cells (row b)
  const auto dh_at = [&](int b, int par, float (&dh)[2]) {
    dh_sum<NCL>(kcar, slots, plane, static_cast<size_t>(b) * D + gu, par,
                dh);
  };

  for (int t = n_steps - 1; t >= 0; --t) {
    const int done = n_steps - 1 - t;  // steps behind this one
    // (1) the cells: dx[t], the carries, db's sums
    for (int r0 = 0; r0 < B; r0 += kGRows) {
      float gq[4][4][2], cpv[4][2], dhv[4][2], dcv[4][2], dh[4][2], dc[4][2];
      float len[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = r0 + rr + 32 * i;
        const bool ok = b < B;
        const int bb = ok ? b : 0;
        const size_t n = static_cast<size_t>(t) * B + bb;
        auto ld2 = [](const bf16* p, float* v) {
          const float2 f = bf2_to_f2(*reinterpret_cast<const unsigned*>(p));
          v[0] = f.x;
          v[1] = f.y;
        };
#pragma unroll
        for (int q = 0; q < 4; ++q) ld2(gates + n * G + q * D + gu, gq[i][q]);
        ld2(t > 0 ? cs + (n - B) * D + gu
                  : c0 + static_cast<size_t>(bb) * D + gu,
            cpv[i]);
        ld2(dhs + n * D + gu, dhv[i]);
        ld2(dcs + n * D + gu, dcv[i]);
        len[i] = ok ? lens[bb] : 0.f;
        if (done == 0) {
          dh[i][0] = dh[i][1] = dc[i][0] = dc[i][1] = 0.f;
        } else {
          dh_at(bb, (t + 1) & 1, dh[i]);
          const float2 v = __ldcg(reinterpret_cast<const float2*>(
              ccar + static_cast<size_t>(bb) * D + gu));
          dc[i][0] = v.x;
          dc[i][1] = v.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = r0 + rr + 32 * i;
        if (b >= B) continue;
        const float m = static_cast<float>(t) < len[i] ? 1.f : 0.f;
        float d[4][2], keep[2], dcn[2];
#pragma unroll
        for (int cu = 0; cu < 2; ++cu) {
          float dq[4];
          bwd_cell_rn(gq[i][0][cu], gq[i][1][cu], gq[i][2][cu],
                      gq[i][3][cu], cpv[i][cu],
                      __fadd_rn(dhv[i][cu], dh[i][cu]),
                      __fadd_rn(dcv[i][cu], dc[i][cu]), m, dq, dcn[cu],
                      keep[cu]);
#pragma unroll
          for (int q = 0; q < 4; ++q) d[q][cu] = dq[q];
        }
        const size_t n = static_cast<size_t>(t) * B + b;
        const size_t o = static_cast<size_t>(b) * D + gu;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          store2(dx + n * G + q * D + gu, d[q]);
          if (kDb) {
            dbq[q][0] = __fadd_rn(dbq[q][0], d[q][0]);
            dbq[q][1] = __fadd_rn(dbq[q][1], d[q][1]);
          }
        }
        store2(kcar + o, keep);
        store2(ccar + o, dcn);
      }
    }
    cl_arrive();
    cl_wait();  // the cluster's dgates of step t are in dx
    // (2) the cluster's share of dh_prev at units k0..: dgates [B, 1024]
    // x ws^T [1024, KB], into slots[t & 1][cl]
    const bf16* dsrc = dx + static_cast<size_t>(t) * B * G;
    float* sout = slots + (static_cast<size_t>(t & 1) * NCL + cl) * plane;
    grid_issue(st0, dsrc, G, B, 0, nkc, nch, col);
    grid_issue(st0, dsrc, G, B, 1, nkc, nch, col);
    float acc[2][NCL][4];
    for (int c = 0; c < nch; ++c) {
      const int r0 = c / nkc * kGRows, kc = c % nkc;
      if (kc == 0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int jn = 0; jn < NCL; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][jn][e] = 0.f;
      }
      cp_wait<1>();
      __syncthreads();
      grid_issue(st0, dsrc, G, B, c + 2, nkc, nch, col);
      const uint32_t a_base = st0 + 2 * (c % kGStages) * kGStage + a_lane;
#pragma unroll
      for (int ks = 0; ks < kGK / 16; ++ks) {
        const int k = kc * kGK + 16 * ks;
        uint32_t bf[NCL + 1][2];
#pragma unroll
        for (int jp = 0; jp < NCL; jp += 2) {
          // n-tiles jp (lanes 0-15's rows) and jp + 1 (lanes 16-31's),
          // the second clamped into the warp's range
          const int nt = ng * NCL + min(jp + (lane >> 4), NCL - 1);
          uint32_t r[4];
          ldsm_x4(b_lane + 2 * (8 * nt * ldw + k), r);
          bf[jp][0] = r[0];
          bf[jp][1] = r[1];
          bf[jp + 1][0] = r[2];
          bf[jp + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int m0 = 16 * (mg + 4 * mt);
          if (r0 + m0 >= B) continue;
          uint32_t a[4];
          ldsm_x4(a_base + 2 * (m0 * kGLd + 16 * ks), a);
#pragma unroll
          for (int jn = 0; jn < NCL; ++jn)
            mma_bf16(acc[mt][jn], a, bf[jn][0], bf[jn][1]);
        }
      }
      if (kc != nkc - 1) continue;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int b = r0 + 16 * (mg + 4 * mt) + g + 8 * hh;
          if (b >= B) continue;
#pragma unroll
          for (int jn = 0; jn < NCL; ++jn)
            *reinterpret_cast<float2*>(
                sout + static_cast<size_t>(b) * D + k0 +
                8 * (ng * NCL + jn) + 2 * t4) =
                make_float2(acc[mt][jn][2 * hh], acc[mt][jn][2 * hh + 1]);
        }
      }
    }
    group_sync(counter, static_cast<unsigned>(done + 1) * NCL * kGCl);
  }
  // dh0, dc0: the carries after step 0 (zeros for no step)
  for (int r0 = 0; r0 < B; r0 += kGRows) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = r0 + rr + 32 * i;
      if (b >= B) continue;
      float dh[2] = {0.f, 0.f}, dc[2] = {0.f, 0.f};
      const size_t o = static_cast<size_t>(b) * D + gu;
      if (n_steps > 0) {
        dh_at(b, 0, dh);
        const float2 v = __ldcg(reinterpret_cast<const float2*>(ccar + o));
        dc[0] = v.x;
        dc[1] = v.y;
      }
      store2(dh0 + o, dh);
      store2(dc0 + o, dc);
    }
  }
  if (!kDb) return;
  // db at this CTA's units: the 32 row threads of each unit pair summed in
  // thread order (the stages are free: the last barrier is behind)
  float* dbs = reinterpret_cast<float*>(ws + KB * ldw);  // [32][kGN]
#pragma unroll
  for (int q = 0; q < 4; ++q)
    *reinterpret_cast<float2*>(dbs + rr * kGN + q * kGU + up) =
        make_float2(dbq[q][0], dbq[q][1]);
  __syncthreads();
  if (tid < kGN) {
    float s = 0.f;
    for (int r = 0; r < 32; ++r) s = __fadd_rn(s, dbs[r * kGN + tid]);
    db[(tid / kGU) * D + own + tid % kGU] = s;
  }
}

// ------------ B10/B11, B14/B15 fp32 at D 256, 512, 768: the grid route
//
// The fp32 lane of the grid route (the bf16 lane's notes above hold, the
// differences here). fp32 W is 4 MiB at D 512, more than a 16-CTA cluster
// holds beside any operand stages, and the streaming kernels read all of
// it from L2 every step on the CUDA cores (97-195 us a step at T 100, B
// 128, D 512 on an H100). Here a CTA owns 8 hidden units, so a group is D
// / 128 clusters of 16 CTAs (D 512: 4, the bf16 lane's CTA count at D
// 1024) and a CTA's share of W takes as many bytes as the bf16 lane's at
// twice the D. The step's product is exact to fp32 on the tensor cores as
// 3xTF32 (tf32_mma_cp_async.cuh: tf32 hi and lo halves of both operands,
// a_lo b_hi + a_hi b_lo + a_hi b_hi on mma.sync m16n8k8; bf16 halves
// would keep 16 bits of the 24): warp w takes rows 16 w..16 w + 15 of the
// 128-row tile against all of the CTA's columns, so a thread holds the
// whole cells (four gates) of two rows and two units, and each fragment
// is split as it is loaded from shared memory. The operand's K chunks are
// staged as [3][128][64 + 4] fp32 (the 16-byte pad puts a fragment's 32
// loads on 32 banks, as W's row pad does).
//   lstm_grid_fwd_f32_kernel: B14's recurrence (xg fp32) and B10 (x fp32:
//     the same first term, so one kernel serves both). CTA i keeps the 32
//     gate columns of units 8 i..8 i + 7, [32][D + 4] (n = 8 q + u). In
//     fp32 the stored h is the product's operand and the carry, so h_{t-1}
//     and c_{t-1} are read from hs[t - 1] and cs[t - 1] (h0, c0 at t = 0):
//     no carry scratch.
//   lstm_grid_bwd_f32_kernel: B15's recurrence (with db) and B11's
//     (without). CTA (c, j) owns units 8 NCL j + 8 c.. (NCL = D / 128) and
//     keeps W's rows 8 NCL j.. over its cluster's 512 gate columns, [8
//     NCL][512 + 4]; dx (the unrounded dgates: in fp32 the product's
//     operand) is read back from L2 in K chunks of the cluster's columns;
//     the slots, their sum in cluster order, the carries in scratch and
//     db's sum in thread order are the bf16 lane's.
// What bounds them: the chain of T steps, as in the bf16 lane: a step's
// product is 2 B D 32 FLOP a CTA (4.2 MFLOP at B 128, D 512; three tf32
// products of it), its operand 4 B D bytes a CTA from L2 (256 KB), and the
// group barrier.
constexpr int kFU = 8;              // hidden units a CTA of the fp32 lane
constexpr int kFN = 4 * kFU;        // the forward's gate columns of them
constexpr int kFBwdK = kFN * kGCl;  // the backward's K: a cluster's columns
constexpr int kFLd = kGK + 4;       // row stride of a staged chunk (fp32)
constexpr int kFStage = kGRows * kFLd;

// shared memory of the fp32 lane's CTAs: W's columns [32][D + 4] or rows
// [D / 16][512 + 4], then the staged chunks [3][128][68], all fp32
constexpr int grid_fwd_smem_f32(int D) {
  return 4 * (kFN * (D + 4) + kGStages * kFStage);
}
constexpr int grid_bwd_smem_f32(int D) {
  return 4 * ((D / kGCl) * (kFBwdK + 4) + kGStages * kFStage);
}

// acc[n] += A B over one staged K chunk, as 3xTF32 (in tf32::mma3's
// order: a_lo b_hi, a_hi b_lo, a_hi b_hi): A the warp's 16 rows at `a`
// ([row][k], row stride kFLd), B[k][n] = ws[8 n + g][k0 + k] (row stride
// ldw, a multiple of 4), NT even. The fragments are loaded by ldmatrix
// (fp32 words read as pairs of b16: thread 4 g + t gets word t of row g
// of each 8 x 4 word matrix; A's four in one x4, B's two n-tiles' four in
// one) and split into hi and lo as they are loaded. The tensor
// cores' fp32 sums truncate, so the chunk is summed from zero and added
// to acc by a rounded add: a product over K takes K / 64 truncated chains
// of 24 mma, not one of 3 K / 8 (at K 2048 that chain missed fp32 parity,
// 1.1e-5 of the largest output).
template <int NT>
__device__ __forceinline__ void chunk_product_f32(float (&acc)[NT][4],
                                                  const float* a,
                                                  const float* ws, int ldw,
                                                  int k0) {
  static_assert(NT % 2 == 0, "two n-tiles an ldmatrix");
  const int lane = threadIdx.x & 31, q = lane >> 3, r8 = lane & 7;
  // matrix q of A: rows 8 (q % 2).., words 4 (q / 2).. of the 16 x 8 tile;
  // of B: n-tile q / 2 of the pair, words 4 (q % 2).. (b0, b1)
  const uint32_t a_addr =
      smem_u32(a + (8 * (q & 1) + r8) * kFLd + 4 * (q >> 1));
  const uint32_t b_addr =
      smem_u32(ws + (8 * (q >> 1) + r8) * ldw + k0 + 4 * (q & 1));
  float part[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kGK / 8; ++ks) {
    uint32_t av[4], ahi[4], alo[4];
    ldsm_x4(a_addr + 32 * ks, av);
#pragma unroll
    for (int e = 0; e < 4; ++e) split(__uint_as_float(av[e]), ahi[e], alo[e]);
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t bv[4];
      ldsm_x4(b_addr + 4 * (16 * p * ldw + 8 * ks), bv);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t bh0, bl0, bh1, bl1;
        split(__uint_as_float(bv[2 * h]), bh0, bl0);
        split(__uint_as_float(bv[2 * h + 1]), bh1, bl1);
        float* d = part[2 * p + h];
        mma(d, alo, bh0, bh1);
        mma(d, ahi, bl0, bl1);
        mma(d, ahi, bh0, bh1);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = __fadd_rn(acc[n][e], part[n][e]);
}

__global__ void __launch_bounds__(kThreads, 1)
    lstm_grid_fwd_f32_kernel(const float* __restrict__ xg,
                             const float* __restrict__ w,
                             const float* __restrict__ lens,
                             const float* __restrict__ h0,
                             const float* __restrict__ c0,
                             float* __restrict__ hs, float* __restrict__ cs,
                             float* __restrict__ gates,
                             unsigned* __restrict__ counter, int n_steps,
                             int B, int D) {
  extern __shared__ __align__(16) unsigned char smem_rc[];
  const int ld = D + 4, G = 4 * D;
  const unsigned ncl = gridDim.x / kGCl;
  float* ws = reinterpret_cast<float*>(smem_rc);  // [kFN][ld]
  float* stg = ws + kFN * ld;                     // [kGStages][kGRows][kFLd]
  const uint32_t st0 = smem_u32(stg);
  const int u0 = static_cast<int>(blockIdx.x) * kFU;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  const int uc = u0 + 2 * t4;  // the cells' first unit
  const int nkc = D / kGK, nch = (B + kGRows - 1) / kGRows * nkc;

  // ws[n][k] = W[k][(n / 8) D + u0 + n % 8]: the CTA's gate columns
  for (int i = tid; i < kFN * D; i += kThreads) {
    const int n = i % kFN, k = i / kFN;
    ws[n * ld + k] = __ldg(w + static_cast<size_t>(k) * G +
                           (n / kFU) * D + u0 + n % kFU);
  }
  __syncthreads();
  const auto col = [](int kc, int p) { return kGK * kc + 4 * p; };
  for (int t = 0; t < n_steps; ++t) {
    const size_t prev = static_cast<size_t>(t - 1) * B * D;
    const float* hsrc = t == 0 ? h0 : hs + prev;
    const float* csrc = t == 0 ? c0 : cs + prev;
    grid_issue(st0, hsrc, D, B, 0, nkc, nch, col);
    grid_issue(st0, hsrc, D, B, 1, nkc, nch, col);
    float acc[4][4], xv[2][4][2], hp[2][2], cv[2][2], len[2];
    for (int c = 0; c < nch; ++c) {
      const int kc = c % nkc, m0 = c / nkc * kGRows + 16 * warp;
      if (kc == 0) {  // the row tile's cells: first terms, carries, lengths
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int b = m0 + g + 8 * hh;
          const bool ok = b < B;
          len[hh] = ok ? lens[b] : 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 v =
                ok ? *reinterpret_cast<const float2*>(
                         xg + (static_cast<size_t>(t) * B + b) * G + q * D +
                         uc)
                   : make_float2(0.f, 0.f);
            xv[hh][q][0] = v.x;
            xv[hh][q][1] = v.y;
          }
          const size_t o = static_cast<size_t>(ok ? b : 0) * D + uc;
          const float2 h = __ldcg(reinterpret_cast<const float2*>(hsrc + o));
          const float2 cc = __ldcg(reinterpret_cast<const float2*>(csrc + o));
          hp[hh][0] = h.x;
          hp[hh][1] = h.y;
          cv[hh][0] = cc.x;
          cv[hh][1] = cc.y;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
      }
      cp_wait<1>();
      __syncthreads();  // chunk c is in; stage (c + 2) % 3 is free
      grid_issue(st0, hsrc, D, B, c + 2, nkc, nch, col);
      if (m0 < B) {  // a live row in the warp's m-tile
        chunk_product_f32<4>(acc, stg + (c % kGStages) * kFStage +
                                      16 * warp * kFLd,
                             ws, ld, kc * kGK);
      }
      if (kc != nkc - 1) continue;
      // the cells: rows g (elements 0, 1) and g + 8 (2, 3), units uc, uc + 1
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int b = m0 + g + 8 * hh;
        const float m = static_cast<float>(t) < len[hh] ? 1.f : 0.f;
        float gv[4][2];
#pragma unroll
        for (int cu = 0; cu < 2; ++cu) {
          float p[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)  // (xe_t Wx + b) + h W
            p[q] = __fadd_rn(xv[hh][q][cu], acc[q][2 * hh + cu]);
          cell_rn(p[0], p[1], p[2], p[3], m, hp[hh][cu], cv[hh][cu],
                  gv[0][cu], gv[1][cu], gv[2][cu], gv[3][cu]);
        }
        if (b >= B) continue;
        const size_t row = static_cast<size_t>(t) * B + b;
        store2(hs + row * D + uc, hp[hh]);
        store2(cs + row * D + uc, cv[hh]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          store2(gates + row * G + q * D + uc, gv[q]);
      }
    }
    group_sync(counter, static_cast<unsigned>(t + 1) * ncl * kGCl);
  }
}

template <int NCL, bool kDb>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_grid_bwd_f32_kernel(const float* __restrict__ gates,
                             const float* __restrict__ cs,
                             const float* __restrict__ w,
                             const float* __restrict__ lens,
                             const float* __restrict__ c0,
                             const float* __restrict__ dhs,
                             const float* __restrict__ dcs,
                             float* __restrict__ dx, float* __restrict__ db,
                             float* __restrict__ dh0, float* __restrict__ dc0,
                             float* __restrict__ carry,
                             float* __restrict__ slots,
                             unsigned* __restrict__ counter, int n_steps,
                             int B) {
  constexpr int D = kFU * kGCl * NCL, G = 4 * D, KB = kFU * NCL;
  constexpr int ldw = kFBwdK + 4, nkc = kFBwdK / kGK;
  extern __shared__ __align__(16) unsigned char smem_rc[];
  float* ws = reinterpret_cast<float*>(smem_rc);  // [KB][ldw]
  float* stg = ws + KB * ldw;                     // [kGStages][kGRows][kFLd]
  const uint32_t st0 = smem_u32(stg);
  const int rank = static_cast<int>(cluster_rank());
  const int cl = static_cast<int>(blockIdx.x) / kGCl;
  const int k0 = KB * rank;         // the product's units (W's rows)
  const int own = k0 + kFU * cl;    // the units of this CTA's cells
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  const int up = 2 * (tid & 3), rr = tid >> 2, gu = own + up;
  const int nch = (B + kGRows - 1) / kGRows * nkc;
  const size_t plane = static_cast<size_t>(B) * D;  // a [B][D] fp32 array
  float* kcar = carry;          // (1 - m) dH of the step before
  float* ccar = carry + plane;  // dc

  // ws[o][n] = W[k0 + o][q D + KB j + 8 cl + u], n = 128 q + 8 j + u:
  // the cluster's gate columns (its CTAs' units, rank by rank) in K order
  for (int i = tid; i < KB * (kFBwdK / 4); i += kThreads) {
    const int o = i / (kFBwdK / 4), n = 4 * (i % (kFBwdK / 4));
    const int cw = (n >> 7) * D + KB * ((n >> 3) & 15) + kFU * cl + (n & 7);
    *reinterpret_cast<float4*>(ws + o * ldw + n) = __ldg(
        reinterpret_cast<const float4*>(w + static_cast<size_t>(k0 + o) * G +
                                        cw));
  }
  float dbq[4][2];
#pragma unroll
  for (int q = 0; q < 4; ++q) dbq[q][0] = dbq[q][1] = 0.f;
  __syncthreads();
  // the cluster's dgates of K chunk kc, 4 columns p: gate kc / 2, ranks
  // 8 (kc % 2) + p / 2
  const auto col = [cl](int kc, int p) {
    return (kc >> 1) * D + KB * (8 * (kc & 1) + (p >> 1)) + kFU * cl +
           4 * (p & 1);
  };
  // dh at this thread's cells (row b)
  const auto dh_at = [&](int b, int par, float (&dh)[2]) {
    dh_sum<NCL>(kcar, slots, plane, static_cast<size_t>(b) * D + gu, par,
                dh);
  };
  const auto ld2 = [](const float* p, float* v) {
    const float2 f = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = f.x;
    v[1] = f.y;
  };

  for (int t = n_steps - 1; t >= 0; --t) {
    const int done = n_steps - 1 - t;  // steps behind this one
    // (1) the cells: dx[t], the carries, db's sums; rows rr and rr + 64
    // of each row tile, units gu, gu + 1
    for (int r0 = 0; r0 < B; r0 += kGRows) {
      float gq[2][4][2], cpv[2][2], dhv[2][2], dcv[2][2], dh[2][2], dc[2][2];
      float len[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = r0 + rr + 64 * i;
        const bool ok = b < B;
        const int bb = ok ? b : 0;
        const size_t n = static_cast<size_t>(t) * B + bb;
#pragma unroll
        for (int q = 0; q < 4; ++q) ld2(gates + n * G + q * D + gu, gq[i][q]);
        ld2(t > 0 ? cs + (n - B) * D + gu
                  : c0 + static_cast<size_t>(bb) * D + gu,
            cpv[i]);
        ld2(dhs + n * D + gu, dhv[i]);
        ld2(dcs + n * D + gu, dcv[i]);
        len[i] = ok ? lens[bb] : 0.f;
        if (done == 0) {
          dh[i][0] = dh[i][1] = dc[i][0] = dc[i][1] = 0.f;
        } else {
          dh_at(bb, (t + 1) & 1, dh[i]);
          ld2(ccar + static_cast<size_t>(bb) * D + gu, dc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = r0 + rr + 64 * i;
        if (b >= B) continue;
        const float m = static_cast<float>(t) < len[i] ? 1.f : 0.f;
        float d[4][2], keep[2], dcn[2];
#pragma unroll
        for (int cu = 0; cu < 2; ++cu) {
          float dq[4];
          bwd_cell_rn(gq[i][0][cu], gq[i][1][cu], gq[i][2][cu],
                      gq[i][3][cu], cpv[i][cu],
                      __fadd_rn(dhv[i][cu], dh[i][cu]),
                      __fadd_rn(dcv[i][cu], dc[i][cu]), m, dq, dcn[cu],
                      keep[cu]);
#pragma unroll
          for (int q = 0; q < 4; ++q) d[q][cu] = dq[q];
        }
        const size_t n = static_cast<size_t>(t) * B + b;
        const size_t o = static_cast<size_t>(b) * D + gu;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          store2(dx + n * G + q * D + gu, d[q]);
          if (kDb) {
            dbq[q][0] = __fadd_rn(dbq[q][0], d[q][0]);
            dbq[q][1] = __fadd_rn(dbq[q][1], d[q][1]);
          }
        }
        store2(kcar + o, keep);
        store2(ccar + o, dcn);
      }
    }
    cl_arrive();
    cl_wait();  // the cluster's dgates of step t are in dx
    // (2) the cluster's share of dh_prev at units k0..: dgates [B, 512]
    // x ws^T [512, KB], into slots[t & 1][cl]
    const float* dsrc = dx + static_cast<size_t>(t) * B * G;
    float* sout = slots + (static_cast<size_t>(t & 1) * NCL + cl) * plane;
    grid_issue(st0, dsrc, G, B, 0, nkc, nch, col);
    grid_issue(st0, dsrc, G, B, 1, nkc, nch, col);
    float acc[NCL][4];
    for (int c = 0; c < nch; ++c) {
      const int kc = c % nkc, m0 = c / nkc * kGRows + 16 * warp;
      if (kc == 0) {
#pragma unroll
        for (int jn = 0; jn < NCL; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[jn][e] = 0.f;
      }
      cp_wait<1>();
      __syncthreads();
      grid_issue(st0, dsrc, G, B, c + 2, nkc, nch, col);
      if (m0 < B) {
        chunk_product_f32<NCL>(acc, stg + (c % kGStages) * kFStage +
                                        16 * warp * kFLd,
                               ws, ldw, kc * kGK);
      }
      if (kc != nkc - 1) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int b = m0 + g + 8 * hh;
        if (b >= B) continue;
#pragma unroll
        for (int jn = 0; jn < NCL; ++jn)
          *reinterpret_cast<float2*>(sout + static_cast<size_t>(b) * D + k0 +
                                     8 * jn + 2 * t4) =
              make_float2(acc[jn][2 * hh], acc[jn][2 * hh + 1]);
      }
    }
    group_sync(counter, static_cast<unsigned>(done + 1) * NCL * kGCl);
  }
  // dh0, dc0: the carries after step 0 (zeros for no step)
  for (int r0 = 0; r0 < B; r0 += kGRows) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = r0 + rr + 64 * i;
      if (b >= B) continue;
      float dh[2] = {0.f, 0.f}, dc[2] = {0.f, 0.f};
      const size_t o = static_cast<size_t>(b) * D + gu;
      if (n_steps > 0) {
        dh_at(b, 0, dh);
        ld2(ccar + o, dc);
      }
      store2(dh0 + o, dh);
      store2(dc0 + o, dc);
    }
  }
  if (!kDb) return;
  // db at this CTA's units: the 64 row threads of each unit pair summed in
  // thread order (the stages are free: the last barrier is behind)
  float* dbs = stg;  // [64][kFN]
#pragma unroll
  for (int q = 0; q < 4; ++q)
    *reinterpret_cast<float2*>(dbs + rr * kFN + q * kFU + up) =
        make_float2(dbq[q][0], dbq[q][1]);
  __syncthreads();
  if (tid < kFN) {
    float s = 0.f;
    for (int r = 0; r < 64; ++r) s = __fadd_rn(s, dbs[r * kFN + tid]);
    db[(tid / kFU) * D + own + tid % kFU] = s;
  }
}

// ------------------------- B12/B13 fp32 at D 256, 512, 768: the grid route
//
// The GRU's fp32 recurrences on the LSTM fp32 lane's mechanism (notes
// above): fp32 W resident across a group of D / 128 clusters of 16 CTAs
// of 8 units, all held at once (launch_grid), the products exact to fp32
// as 3xTF32 on mma.sync (chunk_product_f32, each 64-K chunk summed from
// zero), every fp32 cell operation an __f*_rn intrinsic (a row's bits do
// not depend on B). The reset comes before the candidate's product, so
// each step has two products and two exchanges, each ending in a group
// barrier (group_sync):
//   gru_grid_fwd_f32_kernel, B12 (replaces paddle_tpu/kernels/
//     fused_rnn.py:450, _gru_fwd_call's _gru_fwd_kernel) at these D, W
//     split by K over the clusters: CTA (c, j) owns units KB j + 8 c..
//     (KB = 8 NCL: cluster c's units are its CTAs' 128, the K of its
//     products) and keeps W's rows of cluster c's units over the columns
//     u | r | c~ of units KB j .. KB j + KB - 1, [3 KB][128 + 4] (n = KB q
//     + o). A step: (a) each CTA multiplies the cluster's h_{t-1} (a copy
//     in cluster order, hc) by its u | r rows, cluster c's share of g_ur at
//     units KB j.., into fp32 slots [NCL][B][3D]; the group barrier; the
//     owners sum the NCL clusters' slots in cluster order, form u, r and r
//     h_{t-1} (h_{t-1} as stored in hs: in fp32 the stored h is the carry
//     and the operand; r h into rhc, in cluster order), write gates u, r;
//     a cluster barrier (the cluster's r h is its own CTAs'); (b) the same
//     with rhc against the c~ rows; the group barrier; the owners form c~,
//     the blend and the length mask, write hs[t], hc and gates c~; a
//     cluster barrier. The u | r and c~ partials take separate columns of
//     the slots, and one hc and one rhc suffice: every reader of a buffer
//     or a slot of step t reads it before it arrives at the barrier after
//     which step t + 1 writes it again ((a)'s slots and rhc are read before
//     the group barrier of (b), hc before that of (a); (b)'s slots before
//     the group barrier of the next (a)).
//   gru_grid_bwd_f32_kernel, B13's reverse recurrence (replaces :481,
//     _gru_bwd_call's _gru_bwd_kernel, all but dW) at these D: the LSTM's
//     reverse layout (CTA (c, j) owns units KB j + 8 c.., keeps W's rows KB
//     j.. over its cluster's 384 gate columns, [KB][384 + 4], read as they
//     lie) with the GRU's two reductions. A step in reverse: (1) the
//     owners form dh (the carry of the step before: (dh_t u + drh r) + the
//     slots of dur W_ur^T + (1 - m) dH, in the Pallas body's order), du_pre
//     and dc_pre, written to dx [du_pre | dr_pre | dc_pre] (the layout
//     gru_dw reads) and to dgc (the dgates in cluster order); a cluster
//     barrier; (2) each CTA multiplies the cluster's dc_pre columns by its
//     rows: its partial drh, into slots[0]; the group barrier; (3) the
//     owners sum the slots in cluster order, form dr_pre (to dx and dgc)
//     and dh_t u + drh r; a cluster barrier; (4) the cluster's du_pre |
//     dr_pre columns by the rows: the partial dur W_ur^T into slots[1];
//     the group barrier. The carries ((1 - m) dH; dh_t, then dh_t u + drh
//     r) live in fp32 scratch [2][B][D], each element read and written
//     only by the thread of its cell; dh0 is the carry after step 0. No
//     db: the GRU's kernel has none.
// The K-split's and the reverse's operands (hc, rhc, dgc) are scratch in
// cluster order, [NCL][Bp][K] (Bp: B in whole 128-row tiles), so that a
// chunk's row is 256 contiguous bytes, and are multicast to the cluster's
// 16 CTAs (mc_product: one bulk copy a row, each CTA copying 8 rows of a
// tile; three stages), so that L2 serves each chunk once a cluster, where
// cp.async staging from the JAX layout read eight 32-byte pieces a row,
// every CTA its own copy. Owners load kOwnRows rows' inputs before
// computing any.
// What bounds them: the chain of T steps (the card's least time for a call,
// its operations as three tf32 products, is 5-8 % of it): a step's
// products are 2 B D 3D / (D / 8) FLOP a CTA (37.7 MFLOP at B 512, D 512;
// three tf32 products of it) on mma.sync from shared memory, the owners'
// sums and cells (the partials' [B, 3 KB] fp32 through L2), and two group
// and two cluster barriers a step (lstm_probe --grid-ablation --gru).
constexpr int kGruK = kFU * kGCl;      // the forward's K: a cluster's units
constexpr int kGruKLd = kGruK + 4;     // row stride of its W rows (fp32)
constexpr int kGruBwdK = 3 * kGruK;    // the reverse's K: its 384 columns
constexpr int kOwnRows = 4;            // rows an owner loads at once

// shared memory of the GRU's fp32 grid CTAs: W's rows [3 D / 16][132]
// (forward) or [D / 16][388] (reverse), then the staged chunks
// [3][128][68]
constexpr int grid_gru_fwd_smem_f32(int D) {
  return 4 * (3 * (D / kGCl) * kGruKLd + kGStages * kFStage);
}
constexpr int grid_gru_bwd_smem_f32(int D) {
  return 4 * ((D / kGCl) * (kGruBwdK + 4) + kGStages * kFStage);
}

// The K-split forward's and the reverse's staging. Their operands lie in
// cluster order (a cluster's K contiguous in a row, rows padded to whole
// 128-row tiles), and all 16 CTAs of a cluster multiply the same chunks:
// each chunk is multicast to the 16 by bulk copies (one 256-byte row a
// copy), each CTA copying 8 of a tile's 128 rows, so L2 serves a chunk
// once a cluster. full[s] counts the bytes into stage s (each CTA expects
// all 32 KiB), empty[s] the 16 CTAs done reading it (each releases a
// stage on every CTA of the cluster), so no copy lands in a stage a CTA
// still reads. Chunks are numbered through the kernel (seq), the stage
// seq % NS, the phase seq / NS.
struct McPipe {
  uint32_t full0, empty0;  // NS mbarriers each, 8 bytes apart
  unsigned seq;            // the kernel's next chunk
};

__device__ __forceinline__ void mc_init(McPipe& pp, uint64_t* bars, int ns) {
  pp.full0 = smem_u32(bars);
  pp.empty0 = pp.full0 + 8 * ns;
  pp.seq = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      tc::mbar_init(pp.full0 + 8 * s, 1);
      tc::mbar_init(pp.empty0 + 8 * s, kGCl);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// the bulk copy of `bytes` at src into shared memory at dst of every CTA
// of the cluster, completing on bar there
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src,
                                               int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes."
      "multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(static_cast<uint16_t>(0xffff))
      : "memory");
}

// wait for the phase of parity `parity` of the mbarrier at bar; a wait
// longer than kSpinNs traps (a copy that never lands fails the stream
// rather than hang it)
__device__ __forceinline__ void mc_wait(uint32_t bar, uint32_t parity) {
  const unsigned long long t0 = global_ns();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (global_ns() - t0 > kSpinNs) __trap();
  }
}

// the operand's stores by generic writes seen by the bulk copies that
// read them later (after a barrier)
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// stage chunk c of a product (tile c / nkc, K chunk kc0 + c % nkc of a
// cluster-ordered [rows][ld] operand at src) as kernel chunk seq: wait
// until the 16 CTAs have released its stage, expect its bytes, copy this
// CTA's 8 rows
template <int NS>
__device__ __forceinline__ void mc_issue(const McPipe& pp, float* stg,
                                         const float* src, int ld, int nkc,
                                         int kc0, int c, unsigned seq,
                                         int rank) {
  const int tid = threadIdx.x;
  if (tid >= 8) return;
  const int s = static_cast<int>(seq % NS);
  if (seq >= NS) mc_wait(pp.empty0 + 8 * s, (seq / NS - 1) & 1);
  if (tid == 0) tc::mbar_expect_tx(pp.full0 + 8 * s, kGRows * kGK * 4, false);
  const int row = c / nkc * kGRows + 8 * rank + tid;
  bulk_multicast(smem_u32(stg + s * kFStage + (8 * rank + tid) * kFLd),
                 src + static_cast<size_t>(row) * ld + kGK * (kc0 + c % nkc),
                 kGK * 4, pp.full0 + 8 * s);
}

// A product on the multicast staging: for each 128-row tile of the
// cluster-ordered operand src, acc = (the warp's 16 rows, chunks kc0 ..
// kc0 + nkc - 1) x (NT n-tiles of ws from K offset k_ofs:
// chunk_product_f32), then epi(m0, acc) where the warp's m-tile has a
// live row (m0 its first: the thread holds rows m0 + g and m0 + g + 8,
// columns 8 n + 2 t4 and the next)
template <int NT, int NS, typename Epi>
__device__ __forceinline__ void mc_product(McPipe& pp, float* stg,
                                           const float* src, int ld, int B,
                                           int nkc, int kc0, const float* ws,
                                           int ldw, int k_ofs, int rank,
                                           Epi epi) {
  const int warp = threadIdx.x >> 5;
  const int nch = (B + kGRows - 1) / kGRows * nkc;
  const unsigned base = pp.seq;
  for (int c = 0; c < NS - 1 && c < nch; ++c)
    mc_issue<NS>(pp, stg, src, ld, nkc, kc0, c, base + c, rank);
  float acc[NT][4];
  for (int c = 0; c < nch; ++c) {
    const unsigned seq = base + c;
    const int s = static_cast<int>(seq % NS);
    const int kc = c % nkc, m0 = c / nkc * kGRows + 16 * warp;
    if (kc == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    }
    mc_wait(pp.full0 + 8 * s, (seq / NS) & 1);
    if (m0 < B) {  // a live row in the warp's m-tile
      chunk_product_f32<NT>(acc, stg + s * kFStage + 16 * warp * kFLd, ws,
                            ldw, k_ofs + kc * kGK);
      if (kc == nkc - 1) epi(m0, acc);
    }
    __syncthreads();  // every warp is done reading stage s
    if (threadIdx.x < kGCl) tc::mbar_arrive_at(pp.empty0 + 8 * s, threadIdx.x);
    if (c + NS - 1 < nch)
      mc_issue<NS>(pp, stg, src, ld, nkc, kc0, c + NS - 1, seq + NS - 1,
                   rank);
  }
  pp.seq = base + nch;
}

// the NCL clusters' partials at offset o of planes `stride` apart, summed
// in cluster order
template <int NCL>
__device__ __forceinline__ float2 sum_slots(const float* s, size_t stride,
                                            size_t o) {
  float2 v[NCL];
#pragma unroll
  for (int c = 0; c < NCL; ++c)
    v[c] = __ldcg(reinterpret_cast<const float2*>(s + c * stride + o));
#pragma unroll
  for (int c = 1; c < NCL; ++c) {
    v[0].x = __fadd_rn(v[0].x, v[c].x);
    v[0].y = __fadd_rn(v[0].y, v[c].y);
  }
  return v[0];
}

__device__ __forceinline__ float2 ldcg2(const float* p) {
  return __ldcg(reinterpret_cast<const float2*>(p));
}

// h = m (u h_prev + (1 - u) c~) + (1 - m) h_prev, c~ = tanh(s), in the
// Pallas body's order
__device__ __forceinline__ float gru_blend(float u, float hp, float s,
                                          float m, float& c) {
  c = tanhf(s);
  const float ht =
      __fadd_rn(__fmul_rn(u, hp), __fmul_rn(__fsub_rn(1.f, u), c));
  return __fadd_rn(__fmul_rn(m, ht), __fmul_rn(__fsub_rn(1.f, m), hp));
}

template <int NCL>
__global__ void __launch_bounds__(kThreads, 1)
    gru_grid_fwd_f32_kernel(const float* __restrict__ x,
                            const float* __restrict__ w,
                            const float* __restrict__ lens,
                            const float* __restrict__ h0,
                            float* __restrict__ hs, float* __restrict__ gates,
                            float* __restrict__ hr, float* __restrict__ slots,
                            unsigned* __restrict__ counter, int n_steps,
                            int B) {
  constexpr int D = kGruK * NCL, G = 3 * D, KB = kFU * NCL, NW = 3 * KB;
  constexpr int NS = kGStages;
  extern __shared__ __align__(16) unsigned char smem_rc[];
  __shared__ uint64_t mbars[2 * NS];
  float* ws = reinterpret_cast<float*>(smem_rc);  // [NW][kGruKLd]
  float* stg = ws + NW * kGruKLd;                 // [NS][kGRows][kFLd]
  const int rank = static_cast<int>(cluster_rank());
  const int cl = static_cast<int>(blockIdx.x) / kGCl;
  const int tid = threadIdx.x, g = (tid & 31) >> 2, t4 = tid & 3;
  // the owners' cells: rows rr + 64 i, units gu and gu + 1
  const int rr = tid >> 2, gu = KB * rank + kFU * cl + 2 * t4;
  const int nb = KB * rank + 2 * t4;  // the products' columns: nb + 8 j
  const size_t plane = static_cast<size_t>(B) * G;  // a cluster's slots
  float* sout = slots + cl * plane;
  // the operands in cluster order, [2][NCL][Bp][128] copies of h and r h
  // (Bp: B in whole 128-row tiles), a cluster's units contiguous in a row
  // (K order), the owners' at 8 rank
  const size_t cplane = static_cast<size_t>(B + kGRows - 1) / kGRows *
                        kGRows * kGruK;
  float* hc = hr + cl * cplane;
  float* rhc = hr + (NCL + cl) * cplane;
  const int oc = kFU * rank + 2 * t4;
  McPipe pp;
  mc_init(pp, mbars, NS);

  // ws[n][k] = W[KB (k / 8) + 8 cl + k % 8][(n / KB) D + KB rank + n % KB]
  for (int i = tid; i < NW * kGruK; i += kThreads) {
    const int n = i % NW, k = i / NW;
    ws[n * kGruKLd + k] =
        __ldg(w + static_cast<size_t>(KB * (k >> 3) + kFU * cl + (k & 7)) * G +
              (n / KB) * D + KB * rank + n % KB);
  }
  // h0 in cluster order (the owners' cells)
  for (int b = rr; b < B; b += 64)
    *reinterpret_cast<float2*>(hc + static_cast<size_t>(b) * kGruK + oc) =
        ldcg2(h0 + static_cast<size_t>(b) * D + gu);
  fence_to_async();
  cl_arrive();
  cl_wait();  // the cluster's h0 is in hc; its barriers are set up
  // a product's partials at the thread's rows: n-tile q NCL + j at
  // columns (q0 + q) D + nb + 8 j (q0: the product's first gate)
  const auto put = [&](int m0, const auto& acc, int q0) {
    constexpr int NT =
        std::extent<std::remove_reference_t<decltype(acc)>>::value;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int b = m0 + g + 8 * hh;
      if (b >= B) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(
            sout + static_cast<size_t>(b) * G + (q0 + n / NCL) * D + nb +
            8 * (n % NCL)) = make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
    }
  };
  unsigned bars = 0;
  for (int t = 0; t < n_steps; ++t) {
    const float* hsrc =
        t == 0 ? h0 : hs + static_cast<size_t>(t - 1) * B * D;
    const size_t xt = static_cast<size_t>(t) * B;
    // (a) cluster cl's share of h W_ur
    mc_product<2 * NCL, NS>(
        pp, stg, hc, kGruK, B, 2, 0, ws, kGruKLd, 0, rank,
        [&](int m0, float (&acc)[2 * NCL][4]) { put(m0, acc, 0); });
    group_sync(counter, ++bars * NCL * kGCl);
    // u, r, r h at the owners' cells, kOwnRows rows' loads at once (a row
    // past B loads row B - 1 and stores nothing)
    for (int i0 = 0; 64 * i0 < B; i0 += kOwnRows) {
      float2 su[kOwnRows], sr[kOwnRows], xu[kOwnRows], xr[kOwnRows],
          hp[kOwnRows];
#pragma unroll
      for (int i = 0; i < kOwnRows; ++i) {
        const int b = min(rr + 64 * (i0 + i), B - 1);
        const size_t o = static_cast<size_t>(b) * G + gu;
        su[i] = sum_slots<NCL>(slots, plane, o);
        sr[i] = sum_slots<NCL>(slots, plane, o + D);
        const float* xp = x + (xt + b) * G + gu;
        xu[i] = __ldg(reinterpret_cast<const float2*>(xp));
        xr[i] = __ldg(reinterpret_cast<const float2*>(xp + D));
        hp[i] = ldcg2(hsrc + static_cast<size_t>(b) * D + gu);
      }
#pragma unroll
      for (int i = 0; i < kOwnRows; ++i) {
        const int b = rr + 64 * (i0 + i);
        if (b >= B) continue;
        const float u[2] = {sigmoid(__fadd_rn(xu[i].x, su[i].x)),
                            sigmoid(__fadd_rn(xu[i].y, su[i].y))};
        const float r[2] = {sigmoid(__fadd_rn(xr[i].x, sr[i].x)),
                            sigmoid(__fadd_rn(xr[i].y, sr[i].y))};
        *reinterpret_cast<float2*>(rhc + static_cast<size_t>(b) * kGruK +
                                   oc) =
            make_float2(__fmul_rn(r[0], hp[i].x), __fmul_rn(r[1], hp[i].y));
        store2(gates + (xt + b) * G + gu, u);
        store2(gates + (xt + b) * G + D + gu, r);
      }
    }
    fence_to_async();
    cl_arrive();
    cl_wait();  // the cluster's r h is in rhc
    // (b) cluster cl's share of (r h) W_c
    mc_product<NCL, NS>(
        pp, stg, rhc, kGruK, B, 2, 0, ws + 2 * KB * kGruKLd, kGruKLd, 0, rank,
        [&](int m0, float (&acc)[NCL][4]) { put(m0, acc, 2); });
    group_sync(counter, ++bars * NCL * kGCl);
    // c~, the blend under the mask, at the owners' cells
    for (int i0 = 0; 64 * i0 < B; i0 += kOwnRows) {
      float2 sc[kOwnRows], xc[kOwnRows], u[kOwnRows], hp[kOwnRows];
      float len[kOwnRows];
#pragma unroll
      for (int i = 0; i < kOwnRows; ++i) {
        const int b = min(rr + 64 * (i0 + i), B - 1);
        const size_t n = (xt + b) * G + gu;
        sc[i] = sum_slots<NCL>(slots, plane,
                               static_cast<size_t>(b) * G + 2 * D + gu);
        xc[i] = __ldg(reinterpret_cast<const float2*>(x + n + 2 * D));
        u[i] = ldcg2(gates + n);
        hp[i] = ldcg2(hsrc + static_cast<size_t>(b) * D + gu);
        len[i] = lens[b];
      }
#pragma unroll
      for (int i = 0; i < kOwnRows; ++i) {
        const int b = rr + 64 * (i0 + i);
        if (b >= B) continue;
        const size_t n = (xt + b) * G + gu;
        const float m = static_cast<float>(t) < len[i] ? 1.f : 0.f;
        float c[2];
        const float h[2] = {
            gru_blend(u[i].x, hp[i].x, __fadd_rn(xc[i].x, sc[i].x), m, c[0]),
            gru_blend(u[i].y, hp[i].y, __fadd_rn(xc[i].y, sc[i].y), m,
                      c[1])};
        store2(hs + (xt + b) * D + gu, h);
        store2(hc + static_cast<size_t>(b) * kGruK + oc, h);
        store2(gates + n + 2 * D, c);
      }
    }
    fence_to_async();
    cl_arrive();
    cl_wait();  // the cluster's h_t is in hc
  }
}

template <int NCL>
__global__ void __launch_bounds__(kThreads, 1)
    gru_grid_bwd_f32_kernel(const float* __restrict__ gates,
                            const float* __restrict__ hs,
                            const float* __restrict__ w,
                            const float* __restrict__ lens,
                            const float* __restrict__ h0,
                            const float* __restrict__ dhs,
                            float* __restrict__ dx, float* __restrict__ dh0,
                            float* __restrict__ carry,
                            float* __restrict__ slots,
                            float* __restrict__ dg,
                            unsigned* __restrict__ counter, int n_steps,
                            int B) {
  constexpr int D = kGruK * NCL, G = 3 * D, KB = kFU * NCL;
  constexpr int ldw = kGruBwdK + 4, NS = kGStages;
  extern __shared__ __align__(16) unsigned char smem_rc[];
  __shared__ uint64_t mbars[2 * NS];
  float* ws = reinterpret_cast<float*>(smem_rc);  // [KB][ldw]
  float* stg = ws + KB * ldw;                     // [NS][kGRows][kFLd]
  const int rank = static_cast<int>(cluster_rank());
  const int cl = static_cast<int>(blockIdx.x) / kGCl;
  const int k0 = KB * rank;  // the products' units (W's rows)
  const int tid = threadIdx.x, g = (tid & 31) >> 2, t4 = tid & 3;
  const int rr = tid >> 2, gu = k0 + kFU * cl + 2 * t4;  // the owners' cells
  const size_t plane = static_cast<size_t>(B) * D;  // a [B][D] fp32 array
  float* kcar = carry;          // (1 - m) dH
  float* pcar = carry + plane;  // dh_t, then dh_t u + drh r
  float* s_rh = slots;                // [NCL][B][D] partials of drh
  float* s_ur = slots + NCL * plane;  // ... and of dur W_ur^T
  // the dgates in cluster order, [NCL][Bp][384] (Bp: B in whole 128-row
  // tiles), a cluster's gate columns contiguous in a row (K order: 128 q +
  // 8 j + u), the owners' at 8 rank
  float* dgc = dg + static_cast<size_t>(cl) * ((B + kGRows - 1) / kGRows) *
                        kGRows * kGruBwdK;
  const int oc = kFU * rank + 2 * t4;
  McPipe pp;
  mc_init(pp, mbars, NS);  // first used after the first cluster barrier

  // ws[o][n] = W[k0 + o][q D + KB j + 8 cl + u], n = 128 q + 8 j + u: the
  // cluster's gate columns (its CTAs' units, rank by rank) in K order
  for (int i = tid; i < KB * (kGruBwdK / 4); i += kThreads) {
    const int o = i / (kGruBwdK / 4), n = 4 * (i % (kGruBwdK / 4));
    const int cw = (n >> 7) * D + KB * ((n >> 3) & 15) + kFU * cl + (n & 7);
    *reinterpret_cast<float4*>(ws + o * ldw + n) = __ldg(
        reinterpret_cast<const float4*>(w + static_cast<size_t>(k0 + o) * G +
                                        cw));
  }
  // a product's partials at the thread's rows, units k0 + 8 jn + 2 t4
  const auto put = [&](float* s, int m0, const float (&acc)[NCL][4]) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int b = m0 + g + 8 * hh;
      if (b >= B) continue;
#pragma unroll
      for (int jn = 0; jn < NCL; ++jn)
        *reinterpret_cast<float2*>(s + cl * plane + static_cast<size_t>(b) * D +
                                   k0 + 8 * jn + 2 * t4) =
            make_float2(acc[jn][2 * hh], acc[jn][2 * hh + 1]);
    }
  };
  // dh at the cells of row b: (dh_t u + drh r) + dur W_ur^T + (1 - m) dH
  const auto dh_at = [&](int b) {
    const size_t o = static_cast<size_t>(b) * D + gu;
    const float2 p = ldcg2(pcar + o), k = ldcg2(kcar + o);
    const float2 s = sum_slots<NCL>(s_ur, plane, o);
    return make_float2(__fadd_rn(__fadd_rn(p.x, s.x), k.x),
                       __fadd_rn(__fadd_rn(p.y, s.y), k.y));
  };
  unsigned bars = 0;
  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t nt = static_cast<size_t>(t) * B;
    const float* hprev = t > 0 ? hs + (nt - B) * D : h0;
    // (1) du_pre, dc_pre at the owners' cells (rows rr + 64 i), kOwnRows
    // rows' loads at once (a row past B loads row B - 1, stores nothing)
    for (int i0 = 0; 64 * i0 < B; i0 += kOwnRows) {
      float2 dhr[kOwnRows], ur[kOwnRows], cr[kOwnRows], hpr[kOwnRows],
          dvr[kOwnRows];
      float len[kOwnRows];
#pragma unroll
      for (int i = 0; i < kOwnRows; ++i) {
        const int b = min(rr + 64 * (i0 + i), B - 1);
        const size_t n = (nt + b) * G + gu;
        dhr[i] = t == n_steps - 1 ? make_float2(0.f, 0.f) : dh_at(b);
        ur[i] = __ldg(reinterpret_cast<const float2*>(gates + n));
        cr[i] = __ldg(reinterpret_cast<const float2*>(gates + n + 2 * D));
        hpr[i] = __ldg(reinterpret_cast<const float2*>(
            hprev + static_cast<size_t>(b) * D + gu));
        dvr[i] = __ldg(reinterpret_cast<const float2*>(
            dhs + (nt + b) * D + gu));
        len[i] = lens[b];
      }
#pragma unroll
      for (int i = 0; i < kOwnRows; ++i) {
        const int b = rr + 64 * (i0 + i);
        if (b >= B) continue;
        const size_t n = (nt + b) * G + gu, o = static_cast<size_t>(b) * D + gu;
        const float m = static_cast<float>(t) < len[i] ? 1.f : 0.f;
        const float uu[2] = {ur[i].x, ur[i].y}, cc[2] = {cr[i].x, cr[i].y};
        const float hv[2] = {hpr[i].x, hpr[i].y};
        const float dH[2] = {__fadd_rn(dvr[i].x, dhr[i].x),
                             __fadd_rn(dvr[i].y, dhr[i].y)};
        float dht[2], keep[2], du[2], dc[2];
#pragma unroll
        for (int cu = 0; cu < 2; ++cu) {
          dht[cu] = __fmul_rn(m, dH[cu]);
          keep[cu] = __fmul_rn(__fsub_rn(1.f, m), dH[cu]);
          du[cu] = __fmul_rn(
              __fmul_rn(__fmul_rn(dht[cu], __fsub_rn(hv[cu], cc[cu])), uu[cu]),
              __fsub_rn(1.f, uu[cu]));
          dc[cu] = __fmul_rn(__fmul_rn(dht[cu], __fsub_rn(1.f, uu[cu])),
                             __fsub_rn(1.f, __fmul_rn(cc[cu], cc[cu])));
        }
        float* dgo = dgc + static_cast<size_t>(b) * kGruBwdK + oc;
        store2(dx + n, du);
        store2(dx + n + 2 * D, dc);
        store2(dgo, du);
        store2(dgo + 2 * kGruK, dc);
        store2(kcar + o, keep);
        store2(pcar + o, dht);
      }
    }
    fence_to_async();
    cl_arrive();
    cl_wait();  // the cluster's du_pre, dc_pre of step t are in dgc
    // (2) the cluster's share of drh = dc_pre W_c^T at units k0.. (its K
    // chunks 4 and 5)
    mc_product<NCL, NS>(
        pp, stg, dgc, kGruBwdK, B, 2, 4, ws, ldw, 2 * kGruK, rank,
        [&](int m0, float (&acc)[NCL][4]) { put(s_rh, m0, acc); });
    group_sync(counter, ++bars * NCL * kGCl);
    // (3) drh; dr_pre; dh_t u + drh r
    for (int i0 = 0; 64 * i0 < B; i0 += kOwnRows) {
      float2 drr[kOwnRows], ur[kOwnRows], rg[kOwnRows], hpr[kOwnRows],
          dhtr[kOwnRows];
#pragma unroll
      for (int i = 0; i < kOwnRows; ++i) {
        const int b = min(rr + 64 * (i0 + i), B - 1);
        const size_t n = (nt + b) * G + gu, o = static_cast<size_t>(b) * D + gu;
        drr[i] = sum_slots<NCL>(s_rh, plane, o);
        ur[i] = __ldg(reinterpret_cast<const float2*>(gates + n));
        rg[i] = __ldg(reinterpret_cast<const float2*>(gates + n + D));
        hpr[i] = __ldg(reinterpret_cast<const float2*>(hprev + o));
        dhtr[i] = ldcg2(pcar + o);
      }
#pragma unroll
      for (int i = 0; i < kOwnRows; ++i) {
        const int b = rr + 64 * (i0 + i);
        if (b >= B) continue;
        const size_t n = (nt + b) * G + gu, o = static_cast<size_t>(b) * D + gu;
        const float2 drh = drr[i], u = ur[i], r = rg[i], hp = hpr[i],
                     dht = dhtr[i];
        const float dr[2] = {
            __fmul_rn(__fmul_rn(__fmul_rn(drh.x, hp.x), r.x),
                      __fsub_rn(1.f, r.x)),
            __fmul_rn(__fmul_rn(__fmul_rn(drh.y, hp.y), r.y),
                      __fsub_rn(1.f, r.y))};
        const float part[2] = {
            __fadd_rn(__fmul_rn(dht.x, u.x), __fmul_rn(drh.x, r.x)),
            __fadd_rn(__fmul_rn(dht.y, u.y), __fmul_rn(drh.y, r.y))};
        store2(dx + n + D, dr);
        store2(dgc + static_cast<size_t>(b) * kGruBwdK + kGruK + oc, dr);
        store2(pcar + o, part);
      }
    }
    fence_to_async();
    cl_arrive();
    cl_wait();  // the cluster's dr_pre of step t is in dgc
    // (4) the cluster's share of dur W_ur^T at units k0..
    mc_product<NCL, NS>(
        pp, stg, dgc, kGruBwdK, B, 4, 0, ws, ldw, 0, rank,
        [&](int m0, float (&acc)[NCL][4]) { put(s_ur, m0, acc); });
    group_sync(counter, ++bars * NCL * kGCl);
  }
  // dh0: the carry after step 0 (zeros for no step)
  for (int r0 = 0; r0 < B; r0 += kGRows) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = r0 + rr + 64 * i;
      if (b >= B) continue;
      const float2 dh = n_steps > 0 ? dh_at(b) : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(dh0 + static_cast<size_t>(b) * D + gu) = dh;
    }
  }
}

// The fp32 lane of B14/B15's two passes (proj_gemm lane 0), on the
// tensor cores at fp32 parity: out [M][N] = a [M][K] b (+ bias [N]);
// kPre: the pre-pass, b [K][N] (Wx as it lies), fp32 out = xg; else the
// post-pass, b [N][K] (Wx read transposed), out = dxe. 128 x 128 output
// tiles, 8 warps of 32 x 64, K in chunks of 32 staged by cp.async and
// double-buffered ([128][36] for a and b [N][K], [32][136] for b [K][N]:
// each fragment's 32 loads on 32 banks), 3xTF32 on mma.sync, each chunk
// summed from zero and added by a rounded add (as chunk_product_f32);
// rows past M and columns past N read as zeros and are not written. Each
// output sums its K in order: two launches give the same bits. What
// bounds it: its
// products (three tf32 products of 2 M K N FLOP); right and simple, a
// small share of B14/B15's call.
constexpr int kPT = 128;                 // output rows and columns a tile
constexpr int kPK = 32;                  // K a stage
constexpr int kPALd = kPK + 4;           // [row][k] stride
constexpr int kPBLd = kPT + 8;           // b [K][N]: [k][n] stride
constexpr int kPStage = kPT * kPALd + (kPT * kPALd > kPK * kPBLd
                                           ? kPT * kPALd
                                           : kPK * kPBLd);  // floats
constexpr int kProjF32Smem = 4 * 2 * kPStage;

template <bool kPre>
__global__ void __launch_bounds__(kThreads)
    proj_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_rc[];
  float* sm = reinterpret_cast<float*>(smem_rc);  // [2][kPStage]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // the warp's 32 rows, 64 columns
  const int m0 = static_cast<int>(blockIdx.y) * kPT;
  const int n0 = static_cast<int>(blockIdx.x) * kPT;
  const int nk = K / kPK;
  const auto issue = [&](int kc) {
    if (kc < nk) {
      float* as = sm + (kc & 1) * kPStage;
      float* bs = as + kPT * kPALd;
      const int k = kc * kPK;
      for (int i = tid; i < kPT * (kPK / 4); i += kThreads) {
        const int r = i >> 3, p = i & 7, row = m0 + r;
        cp16(smem_u32(as + r * kPALd + 4 * p),
             a + static_cast<size_t>(row < M ? row : 0) * K + k + 4 * p,
             row < M);
        if (kPre) {  // b rows k.., columns n0..: [32][128]
          const int kr = i >> 5, pn = i & 31, cn = n0 + 4 * pn;
          cp16(smem_u32(bs + kr * kPBLd + 4 * pn),
               b + static_cast<size_t>(k + kr) * N + (cn < N ? cn : 0),
               cn < N);
        } else {     // b rows n0.. (its N), columns k..: [128][32]
          const int cn = n0 + r;
          cp16(smem_u32(bs + r * kPALd + 4 * p),
               b + static_cast<size_t>(cn < N ? cn : 0) * K + k + 4 * p,
               cn < N);
        }
      }
    }
    cp_commit();
  };
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  issue(0);
  for (int kc = 0; kc < nk; ++kc) {
    issue(kc + 1);
    cp_wait<1>();
    __syncthreads();  // chunk kc is in
    const float* as = sm + (kc & 1) * kPStage;
    const float* bs = as + kPT * kPALd;
    float part[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kPK / 8; ++ks) {
      const int k = 8 * ks + t4;
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ar = as + (32 * wm + 16 * mt + g) * kPALd + k;
        split(ar[0], ahi[mt][0], alo[mt][0]);
        split(ar[8 * kPALd], ahi[mt][1], alo[mt][1]);
        split(ar[4], ahi[mt][2], alo[mt][2]);
        split(ar[8 * kPALd + 4], ahi[mt][3], alo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = 64 * wn + 8 * nt + g;
        const float b0 = kPre ? bs[k * kPBLd + n] : bs[n * kPALd + k];
        const float b1 = kPre ? bs[(k + 4) * kPBLd + n] : bs[n * kPALd + k + 4];
        uint32_t bh0, bl0, bh1, bl1;
        split(b0, bh0, bl0);
        split(b1, bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma(part[mt][nt], alo[mt], bh0, bh1);
          mma(part[mt][nt], ahi[mt], bl0, bl1);
          mma(part[mt][nt], ahi[mt], bh0, bh1);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], part[mt][nt][e]);
    __syncthreads();  // every warp is done with the stage issue() refills
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int cn = n0 + 64 * wn + 8 * nt + 2 * t4;
    if (cn >= N) continue;
    float bv[2] = {0.f, 0.f};
    if (kPre) load2(bias + cn, bv);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + 32 * wm + 16 * mt + g + 8 * hh;
        if (row >= M) continue;
        float v[2] = {acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]};
        if (kPre) {  // (xe Wx) + b
          v[0] = __fadd_rn(v[0], bv[0]);
          v[1] = __fadd_rn(v[1], bv[1]);
        }
        store2(out + static_cast<size_t>(row) * N + cn, v);
      }
  }
}

template <typename K>
cudaError_t cluster_attrs(K kernel, int smem) {
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// a launch of `tiles` clusters of nc CTAs (the cluster along x)
template <typename K, typename... Args>
cudaError_t launch_cluster(K kernel, int nc, int tiles, int smem,
                           cudaStream_t st, Args... args) {
  const cudaError_t err = cluster_attrs(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(nc);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nc * tiles));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// how many clusters of nc CTAs of `kernel` the card holds at once
template <typename K>
cudaError_t max_clusters(K kernel, int nc, int smem, int* n) {
  cudaError_t err = cluster_attrs(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(nc);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nc));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

// lane 1 (bf16) only; D a multiple of 32 with at most 16 CTAs a cluster;
// bb rows a tile, 16 or 32 (the LSTM, ng 4) or 16, 32 or 48 (the GRU, ng
// 3), both recurrences' shared memory within the opt-in limit
bool bad_cluster(int lane, int n_steps, int B, int D, int bb, int ng = 4) {
  const int mt = bb / 16;
  return lane != 1 || n_steps < 0 || B < 1 || D < kU || D % kU != 0 ||
         D / kU > kMaxCluster || (ng != 3 && ng != 4) || bb % 16 != 0 ||
         mt < 1 || mt > (ng == 3 ? 3 : 2) || fwd_smem(mt, D, ng) > 232448 ||
         bwd_smem(mt, D, ng) > 232448;
}

// the forward recurrence at tiles of bb rows, its first term x of type XT
// (B14's fp32 xg, B10's bf16 x)
template <typename XT>
cudaError_t cluster_fwd(const void* x, const void* w, const float* lens,
                        const void* h0, const void* c0, void* hs, void* cs,
                        void* gates, int n_steps, int B, int D, int bb,
                        cudaStream_t st) {
  const int nc = D / kU, tiles = (B + bb - 1) / bb;
#define CALL(MT)                                                           \
  launch_cluster(lstm_cluster_fwd_kernel<MT, XT>, nc, tiles, fwd_smem(MT, D), \
                 st, static_cast<const XT*>(x), static_cast<const bf16*>(w), \
                 lens, static_cast<const bf16*>(h0),                        \
                 static_cast<const bf16*>(c0), static_cast<bf16*>(hs),      \
                 static_cast<bf16*>(cs), static_cast<bf16*>(gates), n_steps, \
                 B, D)
  return bb == 16 ? CALL(1) : CALL(2);
#undef CALL
}

// B12's recurrence (fwd) or B13's reverse one at tiles of bb rows: the
// kernel of MT = bb / 16 for `tiles` clusters of D / 32 CTAs
cudaError_t gru_cluster(bool fwd, const void* a, const void* b,
                        const void* w, const float* lens, const void* h0,
                        const void* dhs, void* out0, void* out1, int n_steps,
                        int B, int D, int bb, cudaStream_t st) {
  const int nc = D / kU, tiles = (B + bb - 1) / bb;
  const bf16 *a_ = static_cast<const bf16*>(a),
             *b_ = static_cast<const bf16*>(b),
             *w_ = static_cast<const bf16*>(w),
             *h0_ = static_cast<const bf16*>(h0),
             *dhs_ = static_cast<const bf16*>(dhs);
  bf16 *o0 = static_cast<bf16*>(out0), *o1 = static_cast<bf16*>(out1);
#define FWD(MT)                                                            \
  launch_cluster(gru_cluster_fwd_kernel<MT>, nc, tiles, fwd_smem(MT, D, 3), \
                 st, a_, w_, lens, h0_, o0, o1, n_steps, B, D)
#define BWD(MT)                                                            \
  launch_cluster(gru_cluster_bwd_kernel<MT>, nc, tiles, bwd_smem(MT, D, 3), \
                 st, a_, b_, w_, lens, h0_, dhs_, o0, o1, n_steps, B, D)
  if (fwd) return bb == 16 ? FWD(1) : bb == 32 ? FWD(2) : FWD(3);
  return bb == 16 ? BWD(1) : bb == 32 ? BWD(2) : BWD(3);
#undef FWD
#undef BWD
}

// a launch of the grid route: ncl clusters of 16 CTAs, refused unless the
// card holds all of them at once (a spin would wait on a cluster that is
// not resident): checked here, and asked of the CUDA runtime by the
// cooperative attribute beside the cluster dimension, under which the
// launch fails rather than run a group that cannot be resident together
template <typename K, typename... Args>
cudaError_t launch_grid(K kernel, int ncl, int smem, cudaStream_t st,
                        Args... args) {
  int n = 0;
  cudaError_t err = max_clusters(kernel, kGCl, smem, &n);
  if (err != cudaSuccess) return err;
  if (n < ncl) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kGCl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(kGCl * ncl));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// lane 1 (bf16): D a multiple of 256 with 3 to 5 clusters (D 768, 1024,
// 1280); lane 0 (fp32): D 256, 512 or 768 (2, 4 or 6 clusters of 8-unit
// CTAs); both kernels' shared memory within the opt-in limit
bool bad_grid(int lane, int n_steps, int B, int D) {
  if (n_steps < 0 || B < 1) return true;
  if (lane == 0) {
    return (D != 256 && D != 512 && D != 768) ||
           grid_fwd_smem_f32(D) > 232448 || grid_bwd_smem_f32(D) > 232448;
  }
  return lane != 1 || D % (kGU * kGCl) != 0 || D / (kGU * kGCl) < 3 ||
         D / (kGU * kGCl) > 5 || grid_fwd_smem(D) > 232448 ||
         grid_bwd_smem(D) > 232448;
}

// the grid route's forward recurrence, its first term x of type XT (B14's
// fp32 xg, B10's bf16 x); lane 0: every tensor fp32, no carry
template <typename XT>
cudaError_t grid_fwd(int lane, const void* x, const void* w,
                     const float* lens, const void* h0, const void* c0,
                     void* hs, void* cs, void* gates, float* carry,
                     unsigned* counter, int n_steps, int B, int D,
                     cudaStream_t st) {
  if (lane == 0) {
    return launch_grid(lstm_grid_fwd_f32_kernel, D / (kFU * kGCl),
                       grid_fwd_smem_f32(D), st, static_cast<const float*>(x),
                       static_cast<const float*>(w), lens,
                       static_cast<const float*>(h0),
                       static_cast<const float*>(c0), static_cast<float*>(hs),
                       static_cast<float*>(cs), static_cast<float*>(gates),
                       counter, n_steps, B, D);
  }
  return launch_grid(lstm_grid_fwd_kernel<XT>, D / (kGU * kGCl),
                     grid_fwd_smem(D), st, static_cast<const XT*>(x),
                     static_cast<const bf16*>(w), lens,
                     static_cast<const bf16*>(h0),
                     static_cast<const bf16*>(c0), static_cast<bf16*>(hs),
                     static_cast<bf16*>(cs), static_cast<bf16*>(gates), carry,
                     counter, n_steps, B, D);
}

// the grid route's reverse recurrence, with db (B15) or without (B11: db
// null); lane 0: every tensor fp32
cudaError_t grid_bwd(int lane, const void* gates, const void* cs,
                     const void* w, const float* lens, const void* c0,
                     const void* dhs, const void* dcs, void* dx, float* db,
                     void* dh0, void* dc0, float* carry, float* slots,
                     unsigned* counter, int n_steps, int B, int D,
                     cudaStream_t st) {
  if (lane == 0) {
#define F32(NCL, DB)                                                          \
  launch_grid(lstm_grid_bwd_f32_kernel<NCL, DB>, NCL,                        \
              grid_bwd_smem_f32(kFU * kGCl * NCL), st,                       \
              static_cast<const float*>(gates), static_cast<const float*>(cs), \
              static_cast<const float*>(w), lens,                            \
              static_cast<const float*>(c0), static_cast<const float*>(dhs), \
              static_cast<const float*>(dcs), static_cast<float*>(dx), db,   \
              static_cast<float*>(dh0), static_cast<float*>(dc0), carry,     \
              slots, counter, n_steps, B)
    const int ncl = D / (kFU * kGCl);
    if (db == nullptr) {
      return ncl == 2 ? F32(2, false) : ncl == 4 ? F32(4, false)
                                                 : F32(6, false);
    }
    return ncl == 2 ? F32(2, true) : ncl == 4 ? F32(4, true) : F32(6, true);
#undef F32
  }
#define CALL(NCL, DB)                                                       \
  launch_grid(lstm_grid_bwd_kernel<NCL, DB>, NCL, grid_bwd_smem(256 * NCL), \
              st, static_cast<const bf16*>(gates),                          \
              static_cast<const bf16*>(cs), static_cast<const bf16*>(w),    \
              lens, static_cast<const bf16*>(c0),                           \
              static_cast<const bf16*>(dhs), static_cast<const bf16*>(dcs), \
              static_cast<bf16*>(dx), db, static_cast<bf16*>(dh0),          \
              static_cast<bf16*>(dc0), carry, slots, counter, n_steps, B)
  const int ncl = D / (kGU * kGCl);
  if (db == nullptr) {
    return ncl == 3 ? CALL(3, false) : ncl == 4 ? CALL(4, false)
                                                : CALL(5, false);
  }
  return ncl == 3 ? CALL(3, true) : ncl == 4 ? CALL(4, true) : CALL(5, true);
#undef CALL
}

// the GRU's grid route: lane 0 (fp32) only, D 256, 512 or 768 (2, 4 or 6
// clusters of 8-unit CTAs), every kernel's shared memory within the
// opt-in limit
bool bad_grid_gru(int lane, int n_steps, int B, int D) {
  return n_steps < 0 || B < 1 || lane != 0 ||
         (D != 256 && D != 512 && D != 768) ||
         grid_gru_fwd_smem_f32(D) > 232448 ||
         grid_gru_bwd_smem_f32(D) > 232448;
}

// B12 on the grid route: W split by K over the clusters, the partials in
// slots
cudaError_t grid_gru_fwd(const float* x, const float* w,
                         const float* lens, const float* h0, float* hs,
                         float* gates, float* hr, float* slots,
                         unsigned* counter, int n_steps, int B, int D,
                         cudaStream_t st) {
  const int ncl = D / kGruK;
#define CALL(NCL)                                                         \
  launch_grid(gru_grid_fwd_f32_kernel<NCL>, NCL,                          \
              grid_gru_fwd_smem_f32(kGruK * NCL), st, x, w, lens, h0, hs, \
              gates, hr, slots, counter, n_steps, B)
  return ncl == 2 ? CALL(2) : ncl == 4 ? CALL(4) : CALL(6);
#undef CALL
}

// B13's reverse recurrence on the grid route
cudaError_t grid_gru_bwd(const float* gates, const float* hs, const float* w,
                         const float* lens, const float* h0,
                         const float* dhs, float* dx, float* dh0,
                         float* carry, float* slots, float* dg,
                         unsigned* counter, int n_steps, int B, int D,
                         cudaStream_t st) {
#define CALL(NCL)                                                          \
  launch_grid(gru_grid_bwd_f32_kernel<NCL>, NCL,                           \
              grid_gru_bwd_smem_f32(kGruK * NCL), st, gates, hs, w, lens,  \
              h0, dhs, dx, dh0, carry, slots, dg, counter, n_steps, B)
  const int ncl = D / kGruK;
  return ncl == 2 ? CALL(2) : ncl == 4 ? CALL(4) : CALL(6);
#undef CALL
}

}  // namespace rc

}  // namespace

// x [T, B, 3D], w [D, 3D], lens [B] fp32, h0 [B, D] -> hs [T, B, D],
// gates [T, B, 3D]. bb 1, 2, 4, 8: the streaming kernel, one block per bb
// rows (either lane); bb 16, 32, 48: the resident route (bf16), one
// cluster of D / 32 CTAs per bb rows.
extern "C" int gru_fwd(int lane, const void* x, const void* w,
                       const float* lens, const void* h0, void* hs,
                       void* gates, int n_steps, int B, int D, int bb,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bb >= 16) {
    if (rc::bad_cluster(lane, n_steps, B, D, bb, 3)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(rc::gru_cluster(true, x, nullptr, w, lens, h0,
                                            nullptr, hs, gates, n_steps, B,
                                            D, bb, st));
  }
  if (bad_sizes(lane, n_steps, B, D, bb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define GRU_FWD(T, BB) \
  launch_fwd<T, BB>(x, w, lens, h0, hs, gates, n_steps, B, D, st)
  cudaError_t err;
  if (lane == 0) {
    err = bb == 1 ? GRU_FWD(float, 1) : bb == 2 ? GRU_FWD(float, 2)
        : bb == 4 ? GRU_FWD(float, 4) : GRU_FWD(float, 8);
  } else {
    err = bb == 1 ? GRU_FWD(bf16, 1) : bb == 2 ? GRU_FWD(bf16, 2)
        : bb == 4 ? GRU_FWD(bf16, 4) : GRU_FWD(bf16, 8);
  }
#undef GRU_FWD
  return static_cast<int>(err);
}

// gates [T, B, 3D], hs [T, B, D], wt, lens, h0, dhs [T, B, D] -> dx
// [T, B, 3D], dh0 [B, D], reverse time. bb 1, 2, 4, 8: the streaming
// kernel, one block per bb rows, wt = W^T [3D, D]; bb 16, 32, 48: the
// resident route (bf16), one cluster per bb rows, wt = W [D, 3D] itself
// (read transposed from its resident slices).
extern "C" int gru_bwd(int lane, const void* gates, const void* hs,
                       const void* wt, const float* lens, const void* h0,
                       const void* dhs, void* dx, void* dh0, int n_steps,
                       int B, int D, int bb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bb >= 16) {
    if (rc::bad_cluster(lane, n_steps, B, D, bb, 3)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(rc::gru_cluster(false, gates, hs, wt, lens, h0,
                                            dhs, dx, dh0, n_steps, B, D, bb,
                                            st));
  }
  if (bad_sizes(lane, n_steps, B, D, bb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define GRU_BWD(T, BB)                                                    \
  launch_bwd<T, BB>(gates, hs, wt, lens, h0, dhs, dx, dh0, n_steps, B, D, \
                    st)
  cudaError_t err;
  if (lane == 0) {
    err = bb == 1 ? GRU_BWD(float, 1) : bb == 2 ? GRU_BWD(float, 2)
        : bb == 4 ? GRU_BWD(float, 4) : GRU_BWD(float, 8);
  } else {
    err = bb == 1 ? GRU_BWD(bf16, 1) : bb == 2 ? GRU_BWD(bf16, 2)
        : bb == 4 ? GRU_BWD(bf16, 4) : GRU_BWD(bf16, 8);
  }
#undef GRU_BWD
  return static_cast<int>(err);
}

// gates, hs, h0, dx (as above) -> dw [D, 3D]; `part` holds splits * D * 3D
// fp32 partials when splits > 1 (unused, may be null, when 1).
extern "C" int gru_dw(int lane, const void* gates, const void* hs,
                      const void* h0, const void* dx, float* part, void* dw,
                      int n_steps, int B, int D, int splits, void* stream) {
  if (bad_sizes(lane, n_steps, B, D, 1) || splits < 1 || splits > 65535 ||
      (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      lane == 0 ? launch_dw<float, true>(nullptr, hs, h0, gates, dx, part,
                                         dw, n_steps, B, D, 0, splits, st)
                : launch_dw<bf16, true>(nullptr, hs, h0, gates, dx, part,
                                        dw, n_steps, B, D, 0, splits, st);
  return static_cast<int>(err);
}

// ----------------------------------------------------------- LSTM entries

#define LSTM_BB_DISPATCH(CALL)                                        \
  (lane == 0 ? (bb == 1 ? CALL(float, 1) : bb == 2 ? CALL(float, 2)   \
                : bb == 4 ? CALL(float, 4) : CALL(float, 8))          \
             : (bb == 1 ? CALL(bf16, 1) : bb == 2 ? CALL(bf16, 2)     \
                : bb == 4 ? CALL(bf16, 4) : CALL(bf16, 8)))

// B10. x [T, B, 4D] (bias added), w [D, 4D], lens [B] fp32, h0, c0 [B, D]
// -> hs, cs [T, B, D], gates [T, B, 4D] (post-activation i|f|c~|o); one
// block per bb rows.
extern "C" int lstm_fwd(int lane, const void* x, const void* w,
                        const float* lens, const void* h0, const void* c0,
                        void* hs, void* cs, void* gates, int n_steps, int B,
                        int D, int bb, void* stream) {
  if (bad_sizes(lane, n_steps, B, D, bb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, BB)                                                        \
  launch_lstm_fwd<T, BB, false>(x, nullptr, nullptr, w, lens, h0, c0, hs, \
                                cs, gates, n_steps, B, D, 0, st)
  const cudaError_t err = LSTM_BB_DISPATCH(CALL);
#undef CALL
  return static_cast<int>(err);
}

// B14. xe [T, B, E], wx [E, 4D], b [4D], w [D, 4D], lens, h0, c0 -> hs,
// cs, gates as B10.
extern "C" int lstm_proj_fwd(int lane, const void* xe, const void* wx,
                             const void* b, const void* w, const float* lens,
                             const void* h0, const void* c0, void* hs,
                             void* cs, void* gates, int n_steps, int B, int D,
                             int E, int bb, void* stream) {
  if (bad_sizes(lane, n_steps, B, D, bb) || bad_e(E)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, BB)                                                         \
  launch_lstm_fwd<T, BB, true>(xe, wx, b, w, lens, h0, c0, hs, cs, gates, \
                               n_steps, B, D, E, st)
  const cudaError_t err = LSTM_BB_DISPATCH(CALL);
#undef CALL
  return static_cast<int>(err);
}

// B11's recurrence. gates [T, B, 4D], cs [T, B, D], wt = W^T [4D, D],
// lens, c0, dhs, dcs [T, B, D] -> dx [T, B, 4D] (dgates), dh0, dc0 [B, D].
extern "C" int lstm_bwd(int lane, const void* gates, const void* cs,
                        const void* wt, const float* lens, const void* c0,
                        const void* dhs, const void* dcs, void* dx, void* dh0,
                        void* dc0, int n_steps, int B, int D, int bb,
                        void* stream) {
  if (bad_sizes(lane, n_steps, B, D, bb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, BB)                                                        \
  launch_lstm_bwd<T, BB, false>(gates, cs, wt, nullptr, lens, c0, dhs,    \
                                dcs, dx, nullptr, nullptr, nullptr, dh0,  \
                                dc0, n_steps, B, D, 0, st)
  const cudaError_t err = LSTM_BB_DISPATCH(CALL);
#undef CALL
  return static_cast<int>(err);
}

// B15's recurrence. As lstm_bwd, plus wxt = Wx^T [4D, E] -> dxe [T, B, E],
// and db [4D] fp32 (the sum of the unrounded dgates) through db_part
// [ceil(B / bb)][4D] fp32 scratch.
extern "C" int lstm_proj_bwd(int lane, const void* gates, const void* cs,
                             const void* wt, const void* wxt,
                             const float* lens, const void* c0,
                             const void* dhs, const void* dcs, void* dx,
                             void* dxe, float* db_part, float* db, void* dh0,
                             void* dc0, int n_steps, int B, int D, int E,
                             int bb, void* stream) {
  if (bad_sizes(lane, n_steps, B, D, bb) || bad_e(E)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, BB)                                                          \
  launch_lstm_bwd<T, BB, true>(gates, cs, wt, wxt, lens, c0, dhs, dcs, dx, \
                               dxe, db_part, db, dh0, dc0, n_steps, B, D,  \
                               E, st)
  const cudaError_t err = LSTM_BB_DISPATCH(CALL);
#undef CALL
  return static_cast<int>(err);
}

// The dW reductions of B11 (E = 0, xe null) and B15: xe [T, B, E], hs,
// h0, dx (the dgates in W's dtype) -> dw = [dWx; dW] [E + D, 4D]; `part`
// holds splits * (E + D) * 4D fp32 partials when splits > 1 (unused, may
// be null, when 1).
extern "C" int lstm_dw(int lane, const void* xe, const void* hs,
                       const void* h0, const void* dx, float* part, void* dw,
                       int n_steps, int B, int D, int E, int splits,
                       void* stream) {
  if (bad_sizes(lane, n_steps, B, D, 1) || (E != 0 && bad_e(E)) ||
      (E != 0 && xe == nullptr) || splits < 1 || splits > 65535 ||
      (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      lane == 0 ? launch_dw<float, false>(xe, hs, h0, nullptr, dx, part, dw,
                                          n_steps, B, D, E, splits, st)
                : launch_dw<bf16, false>(xe, hs, h0, nullptr, dx, part, dw,
                                         n_steps, B, D, E, splits, st);
  return static_cast<int>(err);
}

// --------------------- B10/B11, B14/B15 bf16: the resident route (rc)

// One of the route's GEMMs (rc::proj_gemm): a persistent grid of as many
// clusters of CM as the card holds at once, at most one a cluster tile;
// the rows of a tile as few as keep the rounds that 128-row tiles would
// take (so the last round is full); then tensor maps of its operands and
// output in boxes of those rows.
template <int BN, int CM, bool kPre, typename Kern>
cudaError_t launch_proj(Kern kernel, const void* a, const void* b,
                        const void* bias, void* out, int M, int K, int N,
                        cudaStream_t st) {
  using C = rc::ProjCfg<BN, kPre>;
  cudaError_t err = opt_in(kernel, C::kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CM;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CM);
  cfg.blockDim = dim3(288);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int clusters = 0;  // the clusters the card holds at once
  if (clusters < 1) {
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
  }
  rc::ProjOps op{static_cast<const bf16*>(bias), M, N, K, 0,
                 (N + BN - 1) / BN, 0};
  const int full_rows = (M + CM * tc::kBM - 1) / (CM * tc::kBM);
  const int rounds = (full_rows * op.n_col + clusters - 1) / clusters;
  const int row_tiles = rounds * clusters / op.n_col;  // >= full_rows
  op.rows = (M + 2 * CM * row_tiles - 1) / (2 * CM * row_tiles);  // <= 64
  op.tiles = (M + 2 * CM * op.rows - 1) / (2 * CM * op.rows) * op.n_col;
  rc::ProjMaps maps;
  err = bf16_tensor_map(&maps.a, a, M, K, K, op.rows);
  if (err == cudaSuccess) {
    err = kPre ? bf16_tensor_map(&maps.b, b, K, N, N, 64)
               : bf16_tensor_map(&maps.b, b, N, K, K, BN / CM);
  }
  if (err == cudaSuccess) {
    err = tensor_map(&maps.out,
                     kPre ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     C::kOutSize, out, M, N, N, C::kBoxCols, op.rows);
  }
  if (err != cudaSuccess) return err;
  const int n_cl = op.tiles < clusters ? op.tiles : clusters;
  cfg.gridDim = dim3(static_cast<unsigned>(CM * n_cl));
  return cudaLaunchKernelEx(&cfg, kernel, op, maps);
}

// The route's two GEMMs: mode 0, the pre-pass (a = xe [M][K = E], b = wx
// [K][N = 4D], bias = b [N] -> out = xg [M][N] fp32); mode 1, the
// post-pass (a = dx [M][K = 4D], b = wx [N = E][K] read transposed ->
// out = dxe [M][N] in dx's dtype). M = T * B; K a multiple of 32, N of 8
// (the tensor maps' 16-byte row strides). Lane 1: bf16 operands
// (proj_gemm's wgmma kernels); lane 0: fp32 operands (rc::proj_f32_kernel,
// 3xTF32).
extern "C" int proj_gemm(int lane, const void* a, const void* b,
                         const void* bias, void* out, int M, int K, int N,
                         int mode, void* stream) {
  if ((lane != 0 && lane != 1) || M < 1 || K < 32 || K % 32 != 0 || N < 8 ||
      N % 8 != 0 || (mode != 0 && mode != 1) ||
      (mode == 0 && bias == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (lane == 0) {
    const dim3 grid((N + rc::kPT - 1) / rc::kPT, (M + rc::kPT - 1) / rc::kPT);
    const auto* af = static_cast<const float*>(a);
    const auto* bf = static_cast<const float*>(b);
    auto* of = static_cast<float*>(out);
    if (mode == 0) {
      err = opt_in(rc::proj_f32_kernel<true>, rc::kProjF32Smem);
      if (err == cudaSuccess) {
        rc::proj_f32_kernel<true><<<grid, rc::kThreads, rc::kProjF32Smem,
                                    st>>>(af, bf,
                                          static_cast<const float*>(bias), of,
                                          M, K, N);
      }
    } else {
      err = opt_in(rc::proj_f32_kernel<false>, rc::kProjF32Smem);
      if (err == cudaSuccess) {
        rc::proj_f32_kernel<false><<<grid, rc::kThreads, rc::kProjF32Smem,
                                     st>>>(af, bf, nullptr, of, M, K, N);
      }
    }
  } else if (mode == 0) {
    err = launch_proj<128, 2, true>(rc::lstm_xg_kernel<128, 2>, a, b, bias,
                                    out, M, K, N, st);
  } else if (N <= 128) {
    err = launch_proj<128, 2, false>(rc::lstm_dxe_kernel<128, 2>, a, b,
                                     nullptr, out, M, K, N, st);
  } else {
    err = launch_proj<256, 2, false>(rc::lstm_dxe_kernel<256, 2>, a, b,
                                     nullptr, out, M, K, N, st);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// B14's recurrence on the resident route. xg [T, B, 4D] fp32 (the
// pre-pass), w [D, 4D], lens [B] fp32, h0, c0 [B, D] -> hs, cs [T, B, D],
// gates [T, B, 4D]; ceil(B / bb) clusters of D / 32 CTAs.
extern "C" int cluster_lstm_fwd(int lane, const void* xg, const void* w,
                                const float* lens, const void* h0,
                                const void* c0, void* hs, void* cs,
                                void* gates, int n_steps, int B, int D,
                                int bb, void* stream) {
  if (rc::bad_cluster(lane, n_steps, B, D, bb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(rc::cluster_fwd<float>(
      xg, w, lens, h0, c0, hs, cs, gates, n_steps, B, D, bb,
      static_cast<cudaStream_t>(stream)));
}

// B10 on the resident route: cluster_lstm_fwd with x [T, B, 4D] bf16 (the
// pre-projected gates plus bias, 4-byte aligned) as the step's first term
// in place of the fp32 xg.
extern "C" int cluster_lstm_fwd_x(int lane, const void* x, const void* w,
                                  const float* lens, const void* h0,
                                  const void* c0, void* hs, void* cs,
                                  void* gates, int n_steps, int B, int D,
                                  int bb, void* stream) {
  if (rc::bad_cluster(lane, n_steps, B, D, bb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(rc::cluster_fwd<bf16>(
      x, w, lens, h0, c0, hs, cs, gates, n_steps, B, D, bb,
      static_cast<cudaStream_t>(stream)));
}

// B15's recurrence on the resident route. gates [T, B, 4D], cs [T, B, D],
// w [D, 4D] (read transposed from its resident slices), lens, c0, dhs,
// dcs -> dx [T, B, 4D] (dgates in bf16), dh0, dc0 [B, D], and db [4D]
// fp32 (the unrounded dgates' sum) through db_part [ceil(B / bb)][4D]
// fp32 scratch. dxe is the post-pass's (proj_gemm mode 1 over dx).
// B11's recurrence passes db_part and db null: no db, no scratch, no
// second launch.
extern "C" int cluster_lstm_bwd(int lane, const void* gates, const void* cs,
                                const void* w, const float* lens,
                                const void* c0, const void* dhs,
                                const void* dcs, void* dx, float* db_part,
                                float* db, void* dh0, void* dc0, int n_steps,
                                int B, int D, int bb, void* stream) {
  if (rc::bad_cluster(lane, n_steps, B, D, bb) ||
      (db_part == nullptr) != (db == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = D / rc::kU, tiles = (B + bb - 1) / bb;
#define CALL(MT, DB)                                                         \
  rc::launch_cluster(                                                       \
      rc::lstm_cluster_bwd_kernel<MT, DB>, nc, tiles, rc::bwd_smem(MT, D),  \
      st, static_cast<const bf16*>(gates), static_cast<const bf16*>(cs),    \
      static_cast<const bf16*>(w), lens, static_cast<const bf16*>(c0),      \
      static_cast<const bf16*>(dhs), static_cast<const bf16*>(dcs),         \
      static_cast<bf16*>(dx), db_part, static_cast<bf16*>(dh0),             \
      static_cast<bf16*>(dc0), n_steps, B, D)
  if (db == nullptr) {
    return static_cast<int>(bb == 16 ? CALL(1, false) : CALL(2, false));
  }
  cudaError_t err = bb == 16 ? CALL(1, true) : CALL(2, true);
#undef CALL
  if (err != cudaSuccess) return static_cast<int>(err);
  // db: the tiles' fp32 partials summed in tile order
  sum_partials4_kernel<float><<<(D + 255) / 256, 256, 0, st>>>(
      reinterpret_cast<const float4*>(db_part), db, D, tiles);
  return static_cast<int>(cudaGetLastError());
}

// out[0] = how many clusters of D / 32 CTAs (tiles of bb rows) the card
// holds at once: the fewer of the two recurrences' of ng gates (4: B14/
// B15's instantiations; B10/B11's have the same shared memory and one CTA
// an SM, so the same count; 3: B12/B13's)
extern "C" int cluster_occupancy(int lane, int* out, int D, int bb, int ng,
                                 void* stream) {
  (void)stream;
  if (rc::bad_cluster(lane, 0, 1, D, bb, ng) || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nc = D / rc::kU, mt = bb / 16;
  int f = 0, b = 0;
#define FWD(K, MT) rc::max_clusters(K, nc, rc::fwd_smem(MT, D, ng), &f)
#define BWD(K, MT) rc::max_clusters(K, nc, rc::bwd_smem(MT, D, ng), &b)
  cudaError_t err;
  if (ng == 4) {
    err = mt == 1 ? FWD((rc::lstm_cluster_fwd_kernel<1, float>), 1)
                  : FWD((rc::lstm_cluster_fwd_kernel<2, float>), 2);
    if (err == cudaSuccess) {
      err = mt == 1 ? BWD((rc::lstm_cluster_bwd_kernel<1, true>), 1)
                    : BWD((rc::lstm_cluster_bwd_kernel<2, true>), 2);
    }
  } else {
    err = mt == 1   ? FWD(rc::gru_cluster_fwd_kernel<1>, 1)
          : mt == 2 ? FWD(rc::gru_cluster_fwd_kernel<2>, 2)
                    : FWD(rc::gru_cluster_fwd_kernel<3>, 3);
    if (err == cudaSuccess) {
      err = mt == 1   ? BWD(rc::gru_cluster_bwd_kernel<1>, 1)
            : mt == 2 ? BWD(rc::gru_cluster_bwd_kernel<2>, 2)
                      : BWD(rc::gru_cluster_bwd_kernel<3>, 3);
    }
  }
#undef FWD
#undef BWD
  out[0] = f < b ? f : b;
  return static_cast<int>(err);
}

// The cluster exchange alone (lstm_cluster_probe_kernel): `tiles`
// clusters of D / 32 CTAs, n_steps steps; mode 0 the forward's, 1 the
// backward's, 2 the barrier alone. out: one float per CTA.
extern "C" int cluster_lstm_probe(int lane, float* out, int n_steps,
                                  int tiles, int D, int bb, int mode,
                                  void* stream) {
  if (rc::bad_cluster(lane, n_steps, 1, D, bb) || tiles < 1 || mode < 0 ||
      mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = D / rc::kU;
  const cudaError_t err =
      bb == 16 ? rc::launch_cluster(rc::lstm_cluster_probe_kernel<1>, nc,
                                    tiles, rc::probe_smem(1, D), st, out,
                                    n_steps, D, mode)
               : rc::launch_cluster(rc::lstm_cluster_probe_kernel<2>, nc,
                                    tiles, rc::probe_smem(2, D), st, out,
                                    n_steps, D, mode);
  return static_cast<int>(err);
}

// B14's recurrence on the grid route (lane 1, bf16: D 768, 1024, 1280;
// lane 0, fp32: D 256, 512, 768). xg [T, B, 4D] fp32 (the pre-pass), w
// [D, 4D], lens [B] fp32, h0, c0 [B, D] -> hs, cs [T, B, D], gates [T, B,
// 4D]; counter (one uint32, zero) and, lane 1 only, carry fp32 [2][B][D]
// scratch; D / 256 (lane 0: D / 128) clusters of 16 CTAs, refused
// (cudaErrorCooperativeLaunchTooLarge) unless the card holds them at once.
// Lane 0 also serves B10 in fp32 (x is then its first term).
extern "C" int grid_lstm_fwd(int lane, const void* xg, const void* w,
                             const float* lens, const void* h0,
                             const void* c0, void* hs, void* cs, void* gates,
                             float* carry, unsigned* counter, int n_steps,
                             int B, int D, void* stream) {
  if (rc::bad_grid(lane, n_steps, B, D) ||
      (lane == 1 && carry == nullptr) || counter == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(rc::grid_fwd<float>(
      lane, xg, w, lens, h0, c0, hs, cs, gates, carry, counter, n_steps, B,
      D, static_cast<cudaStream_t>(stream)));
}

// B10 on the grid route: grid_lstm_fwd with x [T, B, 4D] bf16 (the
// pre-projected gates plus bias) as the step's first term; lane 0 (x
// fp32) is grid_lstm_fwd's.
extern "C" int grid_lstm_fwd_x(int lane, const void* x, const void* w,
                               const float* lens, const void* h0,
                               const void* c0, void* hs, void* cs,
                               void* gates, float* carry, unsigned* counter,
                               int n_steps, int B, int D, void* stream) {
  if (rc::bad_grid(lane, n_steps, B, D) ||
      (lane == 1 && carry == nullptr) || counter == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(rc::grid_fwd<bf16>(
      lane, x, w, lens, h0, c0, hs, cs, gates, carry, counter, n_steps, B,
      D, static_cast<cudaStream_t>(stream)));
}

// B15's recurrence on the grid route. gates [T, B, 4D], cs [T, B, D], w
// [D, 4D] (its rows resident, read as they lie), lens, c0, dhs, dcs ->
// dx [T, B, 4D] (dgates in the lane's dtype), dh0, dc0 [B, D], and db
// [4D] fp32 (the unrounded dgates' sum); carry fp32 [2][B][D], slots fp32
// [2][clusters][B][D] (D / 256 clusters; lane 0: D / 128) and counter (one
// uint32, zero) scratch. B11's recurrence passes db null: no db.
extern "C" int grid_lstm_bwd(int lane, const void* gates, const void* cs,
                             const void* w, const float* lens,
                             const void* c0, const void* dhs,
                             const void* dcs, void* dx, float* db, void* dh0,
                             void* dc0, float* carry, float* slots,
                             unsigned* counter, int n_steps, int B, int D,
                             void* stream) {
  if (rc::bad_grid(lane, n_steps, B, D) || carry == nullptr ||
      slots == nullptr || counter == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(rc::grid_bwd(
      lane, gates, cs, w, lens, c0, dhs, dcs, dx, db, dh0, dc0, carry, slots,
      counter, n_steps, B, D, static_cast<cudaStream_t>(stream)));
}

// B12's recurrence on the grid route (lane 0, fp32: D 256, 512, 768). x
// [T, B, 3D], w [D, 3D], lens [B] fp32, h0 [B, D] -> hs [T, B, D], gates
// [T, B, 3D]; hr fp32 [2][rows padded to whole 128-row tiles][D] (h and
// r h in cluster order), slots fp32 [D / 128][B][3D] and counter (one
// uint32, zero) scratch; W split by K over the clusters. D / 128 clusters
// of 16 CTAs, refused (cudaErrorCooperativeLaunchTooLarge) unless the
// card holds them at once.
extern "C" int grid_gru_fwd(int lane, const void* x, const void* w,
                            const float* lens, const void* h0, void* hs,
                            void* gates, float* hr, float* slots,
                            unsigned* counter, int n_steps, int B, int D,
                            void* stream) {
  if (rc::bad_grid_gru(lane, n_steps, B, D) || hr == nullptr ||
      slots == nullptr || counter == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(rc::grid_gru_fwd(
      static_cast<const float*>(x), static_cast<const float*>(w),
      lens, static_cast<const float*>(h0), static_cast<float*>(hs),
      static_cast<float*>(gates), hr, slots, counter, n_steps, B, D,
      static_cast<cudaStream_t>(stream)));
}

// B13's reverse recurrence on the grid route (lane 0, fp32: D 256, 512,
// 768). gates [T, B, 3D], hs [T, B, D], w [D, 3D] (its rows resident,
// read as they lie), lens, h0, dhs -> dx [T, B, 3D] (du_pre | dr_pre |
// dc_pre), dh0 [B, D]; carry fp32 [2][B][D], slots fp32 [2][D / 128][B]
// [D], dg fp32 [D / 128][B][384] (the dgates in cluster order) and counter
// (one uint32, zero) scratch.
extern "C" int grid_gru_bwd(int lane, const void* gates, const void* hs,
                            const void* w, const float* lens, const void* h0,
                            const void* dhs, void* dx, void* dh0,
                            float* carry, float* slots, float* dg,
                            unsigned* counter, int n_steps, int B, int D,
                            void* stream) {
  if (rc::bad_grid_gru(lane, n_steps, B, D) || carry == nullptr ||
      slots == nullptr || dg == nullptr || counter == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(rc::grid_gru_bwd(
      static_cast<const float*>(gates), static_cast<const float*>(hs),
      static_cast<const float*>(w), lens, static_cast<const float*>(h0),
      static_cast<const float*>(dhs), static_cast<float*>(dx),
      static_cast<float*>(dh0), carry, slots, dg, counter, n_steps, B, D,
      static_cast<cudaStream_t>(stream)));
}

// out[0] = how many 16-CTA clusters of the grid route's kernels of the
// lane at D the card holds at once (the fewest of the recurrences' of ng
// gates at their own shared memory: the LSTM's two, ng 4; the GRU's
// three, ng 3, fp32 only); the route needs D / 256 (lane 0: D / 128).
extern "C" int grid_occupancy(int lane, int* out, int D, int ng,
                              void* stream) {
  (void)stream;
  if (out == nullptr || (ng != 3 && ng != 4) ||
      (ng == 4 ? rc::bad_grid(lane, 0, 1, D)
               : rc::bad_grid_gru(lane, 0, 1, D))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int f = 0, b = 0;
  if (ng == 3) {
    const int ncl = D / rc::kGruK;
#define FWD(NCL)                                                     \
  rc::max_clusters(rc::gru_grid_fwd_f32_kernel<NCL>, rc::kGCl,       \
                   rc::grid_gru_fwd_smem_f32(D), &f)
#define BWD(NCL)                                                     \
  rc::max_clusters(rc::gru_grid_bwd_f32_kernel<NCL>, rc::kGCl,       \
                   rc::grid_gru_bwd_smem_f32(D), &b)
    cudaError_t err = ncl == 2 ? FWD(2) : ncl == 4 ? FWD(4) : FWD(6);
    if (err == cudaSuccess) {
      err = ncl == 2 ? BWD(2) : ncl == 4 ? BWD(4) : BWD(6);
    }
#undef FWD
#undef BWD
    out[0] = f < b ? f : b;
    return static_cast<int>(err);
  }
  if (lane == 0) {
    cudaError_t err =
        rc::max_clusters(rc::lstm_grid_fwd_f32_kernel, rc::kGCl,
                         rc::grid_fwd_smem_f32(D), &f);
    const int ncl = D / (rc::kFU * rc::kGCl);
#define BWD(NCL)                                                        \
  rc::max_clusters(rc::lstm_grid_bwd_f32_kernel<NCL, true>, rc::kGCl,   \
                   rc::grid_bwd_smem_f32(D), &b)
    if (err == cudaSuccess) {
      err = ncl == 2 ? BWD(2) : ncl == 4 ? BWD(4) : BWD(6);
    }
#undef BWD
    out[0] = f < b ? f : b;
    return static_cast<int>(err);
  }
  cudaError_t err = rc::max_clusters(rc::lstm_grid_fwd_kernel<float>,
                                     rc::kGCl, rc::grid_fwd_smem(D), &f);
  const int ncl = D / (rc::kGU * rc::kGCl);
#define BWD(NCL)                                                    \
  rc::max_clusters(rc::lstm_grid_bwd_kernel<NCL, true>, rc::kGCl,   \
                   rc::grid_bwd_smem(256 * NCL), &b)
  if (err == cudaSuccess) err = ncl == 3 ? BWD(3) : ncl == 4 ? BWD(4) : BWD(5);
#undef BWD
  out[0] = f < b ? f : b;
  return static_cast<int>(err);
}
