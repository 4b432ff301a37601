// Paged attention for a chunk of G query rows per slot (B5/B6), for Hopper
// (sm_90a), over float32, bfloat16, int8 and fp8-e4m3 K/V pools: the
// whole-prompt prefill (S = 1, G = the prompt rung) and, later, the
// speculative verify lane (G = gamma + 1).
//
// Replaces paddle_tpu/kernels/paged_attention.py:_chunk_kernel, launched by
// _paged_chunk_call (B5), and _chunk_kernel_quant with _dequant_kv, launched
// by _paged_chunk_call_quant (B6). q is [S, G, H, d]; row g of slot s sees
// the first min(ctx_lens[s, g], P*B) keys of tables[s] (a chunk written at
// positions start..start+G-1 has ctx = start+g+1, so the causal intra-chunk
// mask is carried by the lengths); ctx 0 (a rung padding row, a row past
// the write limit, an inactive slot) writes an exact zero row and reads
// nothing. A quantized lane's key and value are payload * the (block, head)
// scale the block's writer stored. q and out are fp32; every score,
// softmax statistic and sum is fp32; -1e30 is the finite stand-in for -inf.
//
// What bounds it. A rung-384 prefill layer (370 real rows, H 12, d 64) is
// 4 * sum(ctx) * H * d = 211 MFLOP over 4.6 MB (fp32 pools; 1.0 MB bf16,
// 0.9 MB int8/fp8). On the fp32 CUDA cores (67 TFLOP/s) that is 3.1 us of
// arithmetic. Run on the tensor cores at fp32 parity (three tf32 products
// for each fp32 product, 495 TFLOP/s) it is 1.3 us, under the 1.4 us the
// fp32 bytes take at 3.35 TB/s: bytes bound the call. A 1- or 2-byte
// payload is exact in bf16, so its least is three bf16 products (q or P in
// three bf16 pieces, 989 TFLOP/s), 0.64 us, under its 0.9-1.0 us of bytes;
// after a prefix hit (195 MFLOP over fewer bytes) the 1-byte lanes are
// still bound by bytes, the fp32 lane by its products. The design:
//   - Products on the tensor cores (mma.sync m16n8k8 tf32), S = Q K^T and
//     O += P V, at fp32 parity. An fp32 operand x is split into tf32 hi +
//     lo (hi by an integer add and mask, lo = x - hi exactly) and a product
//     is a_lo b_hi + a_hi b_lo + a_hi b_hi (3xTF32). bf16, int8 and e4m3
//     payloads have at most 8 significant bits, exact in tf32, so their K
//     and V have no lo half and those lanes run two products: S = q_hi k +
//     q_lo k, O += (p vs)_hi v + (p vs)_lo v. The scale of a quantized lane
//     is applied outside the product: to S's columns (k_scale, one per key)
//     and to P's columns before the split (v_scale); the plain version
//     scales each element first, so the two differ in fp32 rounding order
//     only. Every 8-term k-step of either product goes into a fresh
//     accumulator that is added to the running sum in fp32 (the tensor
//     core's own adds truncate). Each product runs over 4 (S) or 8 (P V)
//     column tiles before the next, so that many independent chains are in
//     flight. P stays in registers: S's accumulator layout is the A
//     fragment of P V as it lies, the key order of the k-step permuted to
//     match; q is split once a block, in the same permuted dim order as the
//     K fragment loads, its loads issued first so that they overlap the
//     context -> block table -> K/V chain of the first tile.
//   - Staging: K/V tiles of 32 keys by cp.async (16-byte copies where the
//     row and the pool allow, else 8 or 4 bytes, byte loads below that)
//     into a two-stage ring, so the next tile's copy runs under this tile's
//     products. The payload keeps its own width in shared memory (an int8
//     64-d tile is 2 KB a tensor) and is widened to tf32 in the fragment
//     load, 16 bytes a lane; K rows are padded to 64 mod 128 bytes and V
//     rows to 16 mod 64, which makes every fragment load conflict-free.
//     A thread stages one key row: it reads that row's block id once,
//     prefetched an iteration ahead, and copies the row's K, V and scales.
//     Rows past the tile's largest context are zero-filled through the
//     src-size operand from a valid base address: no table entry, K/V row
//     or scale past a row's pages is read. Dims past d are zero-filled.
//   - Reductions: a row lives in the four lanes of a quad, so its tile max
//     is two shuffles; its sum stays a per-lane share, rescaled with the
//     accumulators and reduced over the quad once at the end; each
//     exponential is one ex2 of an explicitly rounded product.
//   - Grid and balance: one 128-thread block per (slot, tile of 32 rows,
//     head), the heaviest row tiles launched first. Its four warps are two
//     16-row warps times two key groups: key tile kt goes to group kt % 2,
//     so the longest row's chain is half its keys; the groups' softmax
//     states are merged in shared memory in group order. At G = 384 that
//     is 144 blocks, up to two an SM. Measured on an H100 (PERF.md), this
//     beat 32-row blocks without a key split by 1.35-1.5x, 64-row blocks
//     of two key groups by 1.26-1.39x and of one by 1.45-1.6x; 16-row
//     blocks of four key groups ran 1.3x slower in fp32 (154 KB of stages:
//     one block an SM) and within 3 % on the other lanes.
//   - Masks and row independence: a warp masks only the tiles that reach
//     past the smallest context of its rows, and skips the tiles at or past
//     the largest. A fully masked or skipped tile leaves a row's state as
//     it was, the split points are fixed key positions (tile kt = keys 32kt
//     .. 32kt + 31), the merge order is fixed, and nothing is atomic. Each
//     fp32 operation on a row's path is an explicit round-to-nearest
//     intrinsic (__fmul_rn, __fadd_rn), so none is contracted into an FMA:
//     the compiler contracts the two rows a lane holds (g and g + 8)
//     differently, which made a row's last bit depend on its place in the
//     tile. So a row's output depends only on its own context and the pool
//     (a row launched alone gives the same bits as inside a chunk), and
//     two launches give the same bits.
// The payload picks, the tf32 products, the staging, the softmax state and
// the key groups' merge are paged_attention.cuh's, shared with the row-tile
// kernel of paged_attention.cu (B1-B4), which folds its tiles transposed.
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; the C entry returns cudaGetLastError().

#include "paged_attention.cuh"

namespace {

using paged::kLog2e;
using paged::kNegInf;

constexpr int kMaxHeadDim = 128;               // d <= 128, d % 4 == 0
constexpr int kKeys = 32;                      // keys per tile
constexpr int kRowWarps = 2;                   // 16-row warps per block
constexpr int kKeyWarps = 2;                   // key groups per block
constexpr int kRows = 16 * kRowWarps;          // rows per block
constexpr int kThreadsC = 32 * kRowWarps * kKeyWarps;

// The chunk kernel's shared memory for one lane (payload T, kD = 64 or 128
// head dims): a two-stage ring of one 32-key tile per key group, then the
// row warps' q fragments.
template <typename T, bool kScaled, int kD>
struct Cfg : paged::Tile<T, kScaled, kD, kKeys> {
  using Base = paged::Tile<T, kScaled, kD, kKeys>;
  static constexpr int kQBytes = kRowWarps * Base::kQBytes;
  static constexpr int kSmem = 2 * kKeyWarps * Base::kBytes + kQBytes;
  // the key groups' merge, in the ring once it is drained
  static_assert((kKeyWarps - 1) * kRowWarps *
                        paged::merge_vals<Base::kNT>() * 32 * 4 <=
                    2 * kKeyWarps * Base::kBytes,
                "merge scratch must fit in the ring");
};

// The four elements of q's A fragment (rows ln / 4 and + 8, dims dim and
// + 1) split into tf32 hi and lo, stored for k-step ks at index ks * 32 +
// ln of qf_hi / qf_lo
__device__ __forceinline__ void q_split(const float qv[4], uint4* qf_hi,
                                        uint4* qf_lo, int at) {
  uint4 hi, lo;
  split(qv[0], hi.x, lo.x);
  split(qv[1], hi.y, lo.y);
  split(qv[2], hi.z, lo.z);
  split(qv[3], hi.w, lo.w);
  qf_hi[at] = hi;
  qf_lo[at] = lo;
}

// Fold the staged tile at `base` (keys k0 .. k0 + kKeys - 1) into st. The
// warp's q fragments are qf_hi / qf_lo (index ks * 32 + lane); ctx[r] is
// row r's context and wmin the smallest of the warp's 16 rows: a tile below
// it needs no mask. Keys at or past a row's context get p = 0; a row with
// every key masked keeps its state bit for bit.
template <class C, typename T, bool kScaled>
__device__ __forceinline__ void fold_tile(paged::RowState<C::kNT>& st,
                                          const char* base,
                                          const uint4* qf_hi,
                                          const uint4* qf_lo, int k0,
                                          const int ctx[2], int wmin,
                                          float sm_scale, int lane) {
  using Pl = paged::Payload<T>;
  constexpr int kNS = C::kNS;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const char* sk = base;
  const char* sv = base + kNS * 8 * C::kPK;
  const float* ksc =
      reinterpret_cast<const float*>(base + kNS * 8 * (C::kPK + C::kPV));
  const float* vsc = ksc + kNS * 8;

  // S = Q K^T, 16 rows x kKeys keys: sc[nt] = keys 8nt .. 8nt + 7
  float sc[kNS][4];
#pragma unroll
  for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < C::kGroups; ++c) {
    uint32_t raw[kNS][4];  // K rows 8nt + gq, chunk 4c + tq
#pragma unroll
    for (int nt = 0; nt < kNS; ++nt) {
      paged::lds<4>(sk + (8 * nt + gq) * C::kPK + 16 * (4 * c + tq), raw[nt]);
    }
#pragma unroll
    for (int j = 0; j < C::kKSG; j += 2) {  // two k-steps a round
      uint32_t qh[2][4], ql[2][4], b[2][kNS][2];
      float f[2][kNS][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int at = (c * C::kKSG + j + u) * 32 + lane;
        const uint4 a = qf_hi[at];
        const uint4 z = qf_lo[at];
        qh[u][0] = a.x; qh[u][1] = a.y; qh[u][2] = a.z; qh[u][3] = a.w;
        ql[u][0] = z.x; ql[u][1] = z.y; ql[u][2] = z.z; ql[u][3] = z.w;
#pragma unroll
        for (int nt = 0; nt < kNS; ++nt) {
          b[u][nt][0] = Pl::pick(raw[nt], 2 * (j + u));
          b[u][nt][1] = Pl::pick(raw[nt], 2 * (j + u) + 1);
#pragma unroll
          for (int e = 0; e < 4; ++e) f[u][nt][e] = 0.f;
        }
        paged::mma_round<Pl::kExact, kNS>(f[u], qh[u], ql[u], b[u]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[nt][e] = __fadd_rn(sc[nt][e], f[u][nt][e]);
          }
        }
      }
    }
  }

  // online softmax: rows gq (r = 0) and gq + 8 (r = 1), keys k0 + 8nt +
  // 2tq + e in sc[nt][2r + e]
  const bool edge = k0 + kNS * 8 > wmin;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * nt + 2 * tq + e;
        float x = sc[nt][2 * r + e];
        if (kScaled) x = __fmul_rn(x, ksc[j]);
        x = __fmul_rn(x, sm_scale);
        if (edge && k0 + j >= ctx[r]) x = kNegInf;
        sc[nt][2 * r + e] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(st.m[r], mx);
    const float alpha =
        exp2f(__fmul_rn(__fsub_rn(st.m[r], m_new), kLog2e));
    st.m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * nt + 2 * tq + e;
        const float x = __fmul_rn(__fsub_rn(sc[nt][2 * r + e], m_new),
                                  kLog2e);
        const float p = edge && k0 + j >= ctx[r] ? 0.f : exp2f(x);
        sc[nt][2 * r + e] = p;
        sum = __fadd_rn(sum, p);
      }
    }
    st.l[r] = __fadd_rn(__fmul_rn(st.l[r], alpha), sum);
#pragma unroll
    for (int nd = 0; nd < C::kNT; ++nd) {
      st.o[nd][2 * r] = __fmul_rn(st.o[nd][2 * r], alpha);
      st.o[nd][2 * r + 1] = __fmul_rn(st.o[nd][2 * r + 1], alpha);
    }
  }

  // O += P V: k-step nt takes keys 8nt + 2t (k index t) and 8nt + 2t + 1
  // (t + 4), the two columns a lane holds of S's n-tile nt
#pragma unroll
  for (int nt = 0; nt < kNS; ++nt) {
    float p[4] = {sc[nt][0], sc[nt][2], sc[nt][1], sc[nt][3]};
    if (kScaled) {
      const float2 vs =
          *reinterpret_cast<const float2*>(vsc + 8 * nt + 2 * tq);
      p[0] = __fmul_rn(p[0], vs.x);
      p[1] = __fmul_rn(p[1], vs.x);
      p[2] = __fmul_rn(p[2], vs.y);
      p[3] = __fmul_rn(p[3], vs.y);
    }
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(p[e], ph[e], pl[e]);
    uint32_t w[2][C::kNU][C::kU / 4];  // V rows 8nt + 2tq and + 1
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
      for (int j = 0; j < C::kNU; ++j) {
        paged::lds<C::kU / 4>(sv + (8 * nt + 2 * tq + x) * C::kPV +
                                  C::kU * (gq + 8 * j),
                              w[x][j]);
      }
    }
#pragma unroll
    for (int rd = 0; rd < C::kNT; rd += 8) {  // eight n-tiles a round
      uint32_t b[8][2];
      float f[8][4];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int nd = rd + u;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          b[u][x] = Pl::pick(w[x][nd / C::kEPU], nd % C::kEPU);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) f[u][e] = 0.f;
      }
      paged::mma_round<Pl::kExact, 8>(f, ph, pl, b);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st.o[rd + u][e] = __fadd_rn(st.o[rd + u][e], f[u][e]);
        }
      }
    }
  }
}

// Each row's sum over its quad: every lane of the quad gets the same bits.
template <int kNT>
__device__ __forceinline__ void quad_sum(paged::RowState<kNT>& st) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.l[r] = __fadd_rn(st.l[r], __shfl_xor_sync(0xffffffffu, st.l[r], 1));
    st.l[r] = __fadd_rn(st.l[r], __shfl_xor_sync(0xffffffffu, st.l[r], 2));
  }
}

// Row half r (row gq + 8r of the warp tile) of the merged state, divided by
// its sum, into orow[0 .. d): four consecutive dims at a time where d % 4
// == 0 (n-tiles nd0 .. nd0 + 3 hold four consecutive dims at each column),
// else element by element. A row with context 0 writes zeros.
template <class C>
__device__ __forceinline__ void store_row(
    float* __restrict__ orow, const paged::RowState<C::kNT>& st, int r,
    bool live, int d, int tq) {
  const float inv = __frcp_rn(st.l[r]);  // ctx 0 rows: l = 0, never read
#pragma unroll
  for (int nd0 = 0; nd0 < C::kNT; nd0 += 4) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int dim =
          (2 * tq + e + 8 * (nd0 / C::kEPU)) * C::kEPU + nd0 % C::kEPU;
      if (dim >= d) continue;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live) {
        v.x = __fmul_rn(st.o[nd0][2 * r + e], inv);
        v.y = __fmul_rn(st.o[nd0 + 1][2 * r + e], inv);
        v.z = __fmul_rn(st.o[nd0 + 2][2 * r + e], inv);
        v.w = __fmul_rn(st.o[nd0 + 3][2 * r + e], inv);
      }
      if (d % 4 == 0) {  // all four or none
        *reinterpret_cast<float4*>(orow + dim) = v;
      } else {
        orow[dim] = v.x;
        if (dim + 1 < d) orow[dim + 1] = v.y;
        if (dim + 2 < d) orow[dim + 2] = v.z;
        if (dim + 3 < d) orow[dim + 3] = v.w;
      }
    }
  }
}

// One block per (slot s, tile of kRows rows, head h), the heaviest tiles
// (the last rows of a causal chunk) first. Warp w: rows 16 (w % kRowWarps)
// .. + 15 of the tile, key group w / kRowWarps.
template <typename T, bool kScaled, int kD>
__global__ void __launch_bounds__(kThreadsC, 2)
paged_attention_chunk_kernel(const float* __restrict__ q,
                             const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ tables,
                             const int* __restrict__ ctx_lens,
                             float* __restrict__ out, int S, int G, int H,
                             int d, int B, int P, int n_row_tiles,
                             int copy_bytes, float sm_scale) {
  using C = Cfg<T, kScaled, kD>;
  extern __shared__ __align__(16) char smem[];
  __shared__ int s_ctx[kRows];

  const int n_sh = S * H;
  const int tile = n_row_tiles - 1 - static_cast<int>(blockIdx.x) / n_sh;
  const int s = (static_cast<int>(blockIdx.x) % n_sh) / H;
  const int h = static_cast<int>(blockIdx.x) % H;
  const int g0 = tile * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rw = warp % kRowWarps;
  const int kg = warp / kRowWarps;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  // q's A fragments, in the K loads' dim order: loaded now, split into hi
  // and lo once the first tile's copies are under way
  constexpr int kQPer = kRowWarps * C::kKS * 32 / kThreadsC;
  float qv[kQPer][4];
#pragma unroll
  for (int u = 0; u < kQPer; ++u) {
    const int i = threadIdx.x + u * kThreadsC;
    const int ln = i & 31;
    const int ks = (i >> 5) % C::kKS;
    const int r0 = g0 + 16 * (i / (32 * C::kKS)) + (ln >> 2);
    const int dim = paged::q_frag_dim<C>(ks, ln);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e & 1);
      const int c = dim + (e >> 1);
      qv[u][e] = r < G && c < d
          ? q[((static_cast<size_t>(s) * G + r) * H + h) * d + c] : 0.f;
    }
  }
  if (threadIdx.x < kRows) {
    const int g = g0 + threadIdx.x;
    const int c = g < G ? ctx_lens[static_cast<size_t>(s) * G + g] : 0;
    s_ctx[threadIdx.x] = max(0, min(c, P * B));  // never past P pages
  }
  __syncthreads();

  int n_keys = 0;  // the tile's largest context
#pragma unroll
  for (int r = 0; r < kRows; ++r) n_keys = max(n_keys, s_ctx[r]);
  const int ctx[2] = {s_ctx[16 * rw + gq], s_ctx[16 * rw + gq + 8]};
  // this warp's rows: keys past wmax are skipped, tiles past wmin masked
  const int wmax = __reduce_max_sync(0xffffffffu, max(ctx[0], ctx[1]));
  const int wmin = __reduce_min_sync(0xffffffffu, min(ctx[0], ctx[1]));
  const int n_kt = (n_keys + kKeys - 1) / kKeys;
  const int n_iter = (n_kt + kKeyWarps - 1) / kKeyWarps;

  // staging: thread -> key row sj of group skg's tile, units sub, sub +
  // kRowWarps, ... of its K and V rows
  const int srow = threadIdx.x / kRowWarps;
  const int sub = threadIdx.x % kRowWarps;
  const int skg = srow / kKeys;
  const int sj = srow % kKeys;
  const int* table = tables + static_cast<size_t>(s) * P;
  auto key_of = [&](int it) { return (it * kKeyWarps + skg) * kKeys + sj; };
  auto block_of = [&](int it) {
    const int key = key_of(it);
    return key < n_keys ? table[key / B] : -1;
  };
  auto stage = [&](int it, int blk) {
    char* base = smem + ((it & 1) * kKeyWarps + skg) * C::kBytes;
    const bool ok = blk >= 0;
    const size_t off =
        ok ? ((static_cast<size_t>(blk) * H + h) * B + key_of(it) % B) * d
           : 0;
    float* sc = reinterpret_cast<float*>(base + kKeys * (C::kPK + C::kPV));
    paged::stage_row<C>(base + sj * C::kPK,
                        base + kKeys * C::kPK + sj * C::kPV,
                        kScaled ? sc + sj : nullptr, sc + kKeys + sj, k_pool,
                        v_pool, k_scale, v_scale, off,
                        ok ? static_cast<size_t>(blk) * H + h : 0, ok, sub,
                        kRowWarps, copy_bytes, d * C::kElem);
  };

  paged::RowState<C::kNT> st;
  st.init();

  int blk_next = -1;
  if (n_iter > 0) stage(0, block_of(0));
  cp_commit();
  if (n_iter > 1) blk_next = block_of(1);
  uint4* qf_hi = reinterpret_cast<uint4*>(smem + 2 * kKeyWarps * C::kBytes);
  uint4* qf_lo = qf_hi + kRowWarps * C::kKS * 32;
#pragma unroll
  for (int u = 0; u < kQPer; ++u) {  // read after the loop's first barrier
    q_split(qv[u], qf_hi, qf_lo, threadIdx.x + u * kThreadsC);
  }
  for (int it = 0; it < n_iter; ++it) {
    cp_wait<0>();
    __syncthreads();  // tiles of `it` landed; every warp is done with it-1
    if (it + 1 < n_iter) stage(it + 1, blk_next);
    cp_commit();
    if (it + 2 < n_iter) blk_next = block_of(it + 2);
    const int k0 = (it * kKeyWarps + kg) * kKeys;
    if (k0 >= wmax) continue;  // no row of this warp sees these keys
    fold_tile<C, T, kScaled>(
        st, smem + ((it & 1) * kKeyWarps + kg) * C::kBytes,
        qf_hi + rw * C::kKS * 32, qf_lo + rw * C::kKS * 32, k0, ctx, wmin,
        sm_scale, lane);
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it holds the merge

  quad_sum(st);
  paged::merge_groups<C::kNT, kKeyWarps>(st, reinterpret_cast<float*>(smem),
                                         kg, rw, kRowWarps, lane);
  if (kg != 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = g0 + 16 * rw + gq + 8 * r;
    if (g >= G) continue;
    store_row<C>(out + ((static_cast<size_t>(s) * G + g) * H + h) * d,
                        st, r, ctx[r] > 0, d, tq);
  }
}

template <typename T, bool kScaled, int kD>
cudaError_t launch(const float* q, const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const int* ctx_lens, float* out, int S,
                   int G, int H, int d, int B, int P, int n_row_tiles,
                   int copy_bytes, float sm_scale, cudaStream_t st) {
  constexpr int smem = Cfg<T, kScaled, kD>::kSmem;
  auto* kernel = paged_attention_chunk_kernel<T, kScaled, kD>;
  // the attribute belongs to the current device: set at every launch
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(n_row_tiles * S * H), kThreadsC, smem,
           st>>>(q, static_cast<const T*>(k_pool),
                 static_cast<const T*>(v_pool), k_scale, v_scale, tables,
                 ctx_lens, out, S, G, H, d, B, P, n_row_tiles, copy_bytes,
                 sm_scale);
  return cudaGetLastError();
}

template <typename T, bool kScaled>
cudaError_t launch_lane(const float* q, const void* k_pool,
                        const void* v_pool, const float* k_scale,
                        const float* v_scale, const int* tables,
                        const int* ctx_lens, float* out, int S, int G, int H,
                        int d, int B, int P, float sm_scale,
                        cudaStream_t st) {
  const int n_row_tiles = (G + kRows - 1) / kRows;
  // the widest copy that the row length and both pools' alignment allow
  const int row = d * static_cast<int>(sizeof(T));
  const uintptr_t at = reinterpret_cast<uintptr_t>(k_pool) |
                       reinterpret_cast<uintptr_t>(v_pool);
  int copy_bytes = 0;
  for (int w = 16; w >= 4; w /= 2) {
    if (row % w == 0 && at % w == 0) {
      copy_bytes = w;
      break;
    }
  }
  return d <= 64
      ? launch<T, kScaled, 64>(q, k_pool, v_pool, k_scale, v_scale, tables,
                               ctx_lens, out, S, G, H, d, B, P, n_row_tiles,
                               copy_bytes, sm_scale, st)
      : launch<T, kScaled, kMaxHeadDim>(q, k_pool, v_pool, k_scale, v_scale,
                                        tables, ctx_lens, out, S, G, H, d, B,
                                        P, n_row_tiles, copy_bytes, sm_scale,
                                        st);
}

}  // namespace

// q [S, G, H, d] fp32, tables [S, P] int32, ctx_lens [S, G] int32, out
// [S, G, H, d] fp32. lane 0: float32 pools; 1: bfloat16; 2: int8 with
// scales; 3: fp8-e4m3 with scales (k_scale/v_scale [N, H] fp32, ignored on
// lanes 0 and 1). head_dim must be a multiple of 4, at most 128.
extern "C" int paged_attention_chunk(
    int lane, const float* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* tables,
    const int* ctx_lens, float* out, int S, int G, int H, int d, int B,
    int P, float sm_scale, void* stream) {
  if (S <= 0 || G <= 0 || H <= 0) return 0;  // nothing to do
  const long long n_row_tiles = (G + kRows - 1) / kRows;
  if (d < 4 || d > kMaxHeadDim || d % 4 != 0 || B < 1 || P < 1 ||
      lane < 0 || lane > 3 ||
      static_cast<long long>(S) * H * n_row_tiles > 2147483647LL ||
      static_cast<long long>(P) * B > 2147483647LL ||
      (lane >= 2 && (k_scale == nullptr || v_scale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (lane) {
    case 0:
      err = launch_lane<float, false>(q, k_pool, v_pool, k_scale, v_scale,
                                      tables, ctx_lens, out, S, G, H, d, B,
                                      P, sm_scale, st);
      break;
    case 1:
      err = launch_lane<__nv_bfloat16, false>(
          q, k_pool, v_pool, k_scale, v_scale, tables, ctx_lens, out, S, G,
          H, d, B, P, sm_scale, st);
      break;
    case 2:
      err = launch_lane<int8_t, true>(q, k_pool, v_pool, k_scale, v_scale,
                                      tables, ctx_lens, out, S, G, H, d, B,
                                      P, sm_scale, st);
      break;
    default:
      err = launch_lane<__nv_fp8_e4m3, true>(
          q, k_pool, v_pool, k_scale, v_scale, tables, ctx_lens, out, S, G,
          H, d, B, P, sm_scale, st);
      break;
  }
  return static_cast<int>(err);
}
