// Paged attention for the mixed chunked-prefill + decode step (B1/B2) and
// for the whole-mode decode step (B3/B4), for Hopper (sm_90a), over
// float32, bfloat16, int8 and fp8-e4m3 K/V pools: one row-tile kernel,
// paged_attention_rows_kernel, behind both C entries.
//
// paged_attention_mixed replaces paddle_tpu/kernels/paged_attention.py:
// _mixed_kernel and its launcher _paged_mixed_call (float lanes: float32,
// and bfloat16 payloads, which the TPU kernel loads as k_ref[0].astype(f32)),
// and _mixed_kernel_quant with _dequant_kv, launched by
// _paged_mixed_call_quant (int8 and e4m3 payloads with per-block fp32 scales
// [N, H]). Each of the T rows of the mixed step is one query token with its
// own slot and its own context length; the row reads its slot's block table
// (two-level indirection: row -> slot -> physical block).
//
// paged_attention_decode replaces _decode_kernel, launched by _paged_call
// (B3), and _decode_kernel_quant, launched by _paged_call_quant (B4): the
// whole-mode decode step's ONE query per slot over tables[s], with
// seq_lens[s] keys (the slot's own token included). It launches the same
// kernel with row i on slot i.
//
// A row folds the keys at positions below its context into an fp32 online
// softmax and writes its [H, d] output; a row with context 0 (an inactive
// slot, an unused or masked row) writes an exact zero and reads nothing. q
// and out are fp32; every score, statistic and sum is fp32; -1e30 is the
// finite stand-in for -inf. A quantized lane's key and value are payload *
// the (block, head) scale the block's writer stored.
//
// What bounds it. A row of context ctx reads ctx*H*d*e*2 bytes of K and V
// (e = 4, 2 or 1) and does 4*ctx*H*d FLOPs, at most 2 FLOP a byte: far
// under the ~295 where an H100 stops being memory bound, so bytes bound it
// when each key is read once. The parent kernel (one 256-thread block per
// (row, head), each folding its row alone on the CUDA cores) read a slot's
// K/V once for EVERY row: the engine packs a prefilling request's chunk
// rows one after another on one slot (up to 64 at the default chunk size),
// so one launch read K/V dozens of times over, and its bf16 / int8 / e4m3
// lanes loaded one element a lane. The smoke's mixed step (80 rows: 16
// decode rows, two 32-row chunks; H 12, d 64, ctx <= 512) ran 11x (fp32) to
// 48x (int8) its byte bound. A launch that meets its pool cold waits on
// three dependent DRAM round trips (slot, table entry, first K/V tile)
// before its first fold, and a long row is then a chain of tiles, each a
// copy and a fold: the design keeps many tiles in flight and the chain
// short. The design:
//   - Row tiles. Consecutive rows on one slot form a tile of up to 8 rows:
//     a tile starts at row 0, at every multiple of 8 and wherever the slot
//     changes, found on the device from row_slots (one block per (row,
//     head), heads fastest, so all heads of the decode rows go first; a
//     block whose row starts no tile returns at once, so nothing is read
//     back to the host). Decode rows, each on its own slot, are tiles of
//     one. A block stages each key of its slot once for the whole tile.
//   - Transposed products on the tensor cores (mma.sync m16n8k8 tf32 at
//     fp32 parity, from paged_attention.cuh's pieces: 3xTF32 for fp32
//     pools, two tf32 products for the 1- and 2-byte payloads, exact in
//     tf32, the scales outside the products). S^T = K q^T and O^T += V^T P^T put 16 keys or
//     16 dims on the mma's M and the tile's 8 rows on its N, so a tile of
//     one wastes 7 of 8 columns, not 15 of 16 rows: half the products of
//     the chunk kernel's layout (which B5/B6 keep) for the decode rows that
//     hold most of the bytes. P moves from S's fragment to P^T's by
//     shuffles.
//   - Split keys. The block's kNG warps are key groups: tile kt of 16 keys
//     (keys 16kt .. 16kt + 15) goes to group kt % kNG, so a 512-key row is
//     32 / kNG tiles deep, not 512 / 8 keys as before; the groups' softmax
//     states merge in shared memory in group order. Each group stages its
//     own tiles through a private ring of kStages, the block ids of the
//     next tile loaded a tile ahead and the copies of the tiles ahead under
//     this tile's products, no block-wide barrier in the loop. Eight groups
//     of three stages where that leaves two blocks an SM; fp32 takes four
//     of three (RowsCfg). Where a tile's 16 keys lie in one page (B % 16 ==
//     0) and d fills the instantiation's width, the tile's K rows and V
//     rows are one run each: two bulk copies (cp.async.bulk, counted on the
//     stage's mbarrier) move it: issuing per-lane copies (32 16-byte copies
//     a lane for two fp32 tiles) had held the fp32 lane back, from its
//     first tile on. Otherwise lanes copy by cp.async
//     (two lanes a key row, 16-byte copies where the row and both pools
//     allow, else 8 or 4 bytes, byte loads below that: a 64-d int8 row is
//     four lanes). Keys past the tile's largest context are not copied
//     (bulk: rows past the prefix some row needs are zeroed; cp.async:
//     zero-filled through the src-size operand from a valid address): no
//     table entry, K/V row or scale past the slot's needed pages is read.
//     Dims past d are zero-filled, so any d <= 256 runs (instantiated at
//     64, 128 and 256).
//   - Row independence. A row's bits depend only on its q, its context and
//     its slot's pages, not on T, its index, its tile's other rows or where
//     the tiles fall: the split points are fixed key positions, the merge
//     order is fixed, a fully masked tile leaves a row's state bit for bit,
//     nothing is atomic, each output element is one row's dot products on
//     the tensor core, and every fp32 operation on a row's path is an
//     explicit round-to-nearest intrinsic. A row in an 8-row tile and the
//     same row alone give the same bits, and paged_attention_decode gives
//     paged_attention_mixed's bits on identity slots. The engine's "solo
//     and batched greedy tokens are equal" relies on it.
// Tried on the card and not kept (PERF.md; ranking only): 16-row tiles in
// the chunk kernel's layout (twice the products for a tile of one), key
// spans split over the blocks of a thread-block cluster and merged through
// DSMEM (the cluster launches started their blocks late), padded tiles
// (fewer stages), and tiles of 32 keys.
//
// Built by paddle_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; each C entry returns cudaGetLastError().

#include "paged_attention.cuh"

namespace {

using paged::kLog2e;
using paged::kNegInf;

constexpr int kMaxHeadDim = 256;
constexpr int kTileRows = 8;   // rows of a tile: the mma's N
constexpr int kKeys = 16;      // keys of a staged tile: the mma's M
constexpr int kLanesPerKey = 32 / kKeys;
constexpr int kMaxStages = 8;
// shared memory that leaves two blocks an SM, and a block's most
constexpr int kTwoABlock = 104 * 1024;
constexpr int kMostABlock = 220 * 1024;

// One lane's (payload T, kD head dims) tile, key groups, stages and shared
// memory: the groups' rings (the merge scratch in their place once they
// drain), q's fragments, then the tile's contexts and length. The staged
// tiles are unpadded (a fragment load's bank conflicts cost less than the
// stages they would take). Eight key groups of three stages where that
// leaves two blocks an SM (the 1- and 2-byte payloads at d 64), else four
// (two stages fit two blocks an SM for fp32 at d 64), else two; then as
// many stages as leave two blocks an SM, at least two.
template <typename T, bool kScaled, int kD>
struct RowsCfg {
  using C = paged::Tile<T, kScaled, kD, kKeys, false>;
  static constexpr int kQBytes = C::kKS * 32 * 16;  // hi and lo of 8 rows
  static constexpr int kNG =
      8 * 3 * C::kBytes + kQBytes <= kTwoABlock   ? 8
      : 4 * 2 * C::kBytes + kQBytes <= kMostABlock ? 4
                                                   : 2;
  static constexpr int kFit = (kTwoABlock - kQBytes) / (kNG * C::kBytes);
  static constexpr int kStages =
      kFit < 2 ? 2 : kFit > kMaxStages ? kMaxStages : kFit;
  static constexpr int kThreads = 32 * kNG;
  static constexpr int kMT = kD / 16;  // O^T's m-tiles
  static constexpr int kRing = kNG * kStages * C::kBytes;
  static constexpr int kMerge =
      (kNG - 1) * paged::merge_vals<kMT>() * 32 * 4;
  static constexpr int kQAt = kRing > kMerge ? kRing : kMerge;
  static constexpr int kInfoAt = kQAt + kQBytes;
  // each group's stage barriers (bulk copies), 8-byte aligned
  static constexpr int kBarAt = (kInfoAt + (kTileRows + 1) * 4 + 7) / 8 * 8;
  static constexpr int kSmem = kBarAt + kNG * kStages * 8;
  // V^T's fragments: lane g reads the dims g * kD / 8 .. + kD / 8 - 1 of a
  // V row, kRunW 32-bit words
  static constexpr int kRunW = kD * C::kElem / 32;
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
};

// Bulk copies: one instruction moves a contiguous run global -> shared and
// counts its bytes on an mbarrier (one a stage), which the warp waits on.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
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
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// order this thread's shared-memory accesses before later bulk copies
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Fold the staged tile at `base` (keys k0 .. k0 + 15) into st, transposed:
// keys on the mma's M, the tile's 8 rows on its N, so a tile of one row
// wastes 7 of 8 columns rather than 15 of 16 rows.
//   S^T = K q^T: lane (g, t) holds keys g, g + 8 (element e >> 1) of rows
//   2t, 2t + 1 (e & 1). K's A fragment is K rows g and g + 8, 16 bytes at
//   chunk 4c + t, in the K loads' permuted dim order (paged::q_frag_dim);
//   q's B fragment (qf, index ks * 32 + lane: hi of dims t and t + 4 of
//   row g, then lo) was split once a block.
//   O^T += V^T P^T: O's dims on M (m-tile md's rows g, g + 8 are dims g *
//   kD / 8 + 2md and + 1), so lane (g, t) holds dims g * kD / 8 .. + kD / 8
//   - 1 of rows 2t, 2t + 1 (o[md][e]: dim + (e >> 1), row e & 1). V^T's A
//   fragment is the lane's dims of V rows t and t + 4 of the k-step; P^T's
//   B fragment (row g, keys t and t + 4) comes from S's lanes by shuffles.
// Every k-step of a product goes into a fresh accumulator added in fp32;
// the products are 3xTF32 for an fp32 payload, two tf32 products (q or P
// split, the payload exact) for the others; a quantized lane's scales
// multiply S's and P's keys outside the products.
template <class R, typename T, bool kScaled>
__device__ __forceinline__ void fold_tile_t(paged::RowState<R::kMT>& st,
                                            const char* base,
                                            const uint4* qf, int k0,
                                            const int ctx[2], int wmin,
                                            float sm_scale, int lane) {
  using C = typename R::C;
  using Pl = paged::Payload<T>;
  constexpr int kMT = R::kMT;
  const int g = lane >> 2;
  const int t = lane & 3;
  const char* sk = base;
  const char* sv = base + kKeys * C::kPK;
  const float* ksc =
      reinterpret_cast<const float*>(base + kKeys * (C::kPK + C::kPV));
  const float* vsc = ksc + kKeys;

  // S^T = K q^T over the k-steps of each 16-byte K chunk group
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < C::kGroups; ++c) {
    uint32_t ra[4], rb[4];  // K rows g and g + 8, chunk 4c + t
    paged::lds<4>(sk + g * C::kPK + 16 * (4 * c + t), ra);
    paged::lds<4>(sk + (g + 8) * C::kPK + 16 * (4 * c + t), rb);
    float f[C::kKSG][4];
#pragma unroll
    for (int u = 0; u < C::kKSG; ++u) {
      const uint4 qb = qf[(c * C::kKSG + u) * 32 + lane];
      const uint32_t a[4] = {Pl::pick(ra, 2 * u), Pl::pick(rb, 2 * u),
                             Pl::pick(ra, 2 * u + 1),
                             Pl::pick(rb, 2 * u + 1)};
#pragma unroll
      for (int e = 0; e < 4; ++e) f[u][e] = 0.f;
      if constexpr (Pl::kExact) {
        mma(f[u], a, qb.z, qb.w);  // K q_lo, then K q_hi
        mma(f[u], a, qb.x, qb.y);
      } else {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(__uint_as_float(a[e]), ah[e], al[e]);
        mma(f[u], al, qb.x, qb.y);  // K_lo q_hi, K_hi q_lo, K_hi q_hi
        mma(f[u], ah, qb.z, qb.w);
        mma(f[u], ah, qb.x, qb.y);
      }
    }
#pragma unroll
    for (int u = 0; u < C::kKSG; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[e] = __fadd_rn(sc[e], f[u][e]);
    }
  }

  // online softmax of rows 2t + r: keys k0 + g + 8h in sc[r + 2h]; a row's
  // max over the 8 lanes g that hold its keys
  const bool edge = k0 + kKeys > wmin;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int hk = 0; hk < 2; ++hk) {
      const int j = g + 8 * hk;
      float x = sc[r + 2 * hk];
      if (kScaled) x = __fmul_rn(x, ksc[j]);
      x = __fmul_rn(x, sm_scale);
      if (edge && k0 + j >= ctx[r]) x = kNegInf;
      sc[r + 2 * hk] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float m_new = fmaxf(st.m[r], mx);
    const float alpha =
        exp2f(__fmul_rn(__fsub_rn(st.m[r], m_new), kLog2e));
    st.m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int hk = 0; hk < 2; ++hk) {
      const int j = g + 8 * hk;
      const float x =
          __fmul_rn(__fsub_rn(sc[r + 2 * hk], m_new), kLog2e);
      const float p = edge && k0 + j >= ctx[r] ? 0.f : exp2f(x);
      sc[r + 2 * hk] = p;
      sum = __fadd_rn(sum, p);
    }
    st.l[r] = __fadd_rn(__fmul_rn(st.l[r], alpha), sum);
    // x * 1 is x: a max that did not move (alpha exactly 1) leaves O as it
    // is, bit for bit, without the multiplies
    if (__any_sync(0xffffffffu, alpha != 1.f)) {
#pragma unroll
      for (int md = 0; md < kMT; ++md) {
        st.o[md][r] = __fmul_rn(st.o[md][r], alpha);
        st.o[md][r + 2] = __fmul_rn(st.o[md][r + 2], alpha);
      }
    }
  }

  // O^T += V^T P^T: k-step ks takes keys 8ks .. 8ks + 7; P[row g][key 8ks
  // + t (+ 4)] is element (g & 1) + 2ks of lane (t (+ 4), g >> 1)
  const int src0 = 4 * t + (g >> 1);
  const int src1 = src0 + 16;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const float a0 = __shfl_sync(0xffffffffu, sc[2 * ks], src0);
    const float a1 = __shfl_sync(0xffffffffu, sc[2 * ks + 1], src0);
    const float b0 = __shfl_sync(0xffffffffu, sc[2 * ks], src1);
    const float b1 = __shfl_sync(0xffffffffu, sc[2 * ks + 1], src1);
    float p[2] = {g & 1 ? a1 : a0, g & 1 ? b1 : b0};
    if (kScaled) {
      p[0] = __fmul_rn(p[0], vsc[8 * ks + t]);
      p[1] = __fmul_rn(p[1], vsc[8 * ks + t + 4]);
    }
    uint32_t ph[2], pl[2];
    split(p[0], ph[0], pl[0]);
    split(p[1], ph[1], pl[1]);
    uint32_t run[2][R::kRunW];  // V rows 8ks + t and + 4, the lane's dims
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const char* row = sv + (8 * ks + t + 4 * x) * C::kPV + g * R::kRunW * 4;
      if constexpr (R::kRunW % 4 == 0) {
#pragma unroll
        for (int w = 0; w < R::kRunW; w += 4) paged::lds<4>(row + 4 * w, run[x] + w);
      } else {
#pragma unroll
        for (int w = 0; w < R::kRunW; w += 2) paged::lds<2>(row + 4 * w, run[x] + w);
      }
    }
    float f[kMT][4];
#pragma unroll
    for (int md = 0; md < kMT; ++md) {
      const uint32_t a[4] = {Pl::pick(run[0], 2 * md),
                             Pl::pick(run[0], 2 * md + 1),
                             Pl::pick(run[1], 2 * md),
                             Pl::pick(run[1], 2 * md + 1)};
#pragma unroll
      for (int e = 0; e < 4; ++e) f[md][e] = 0.f;
      if constexpr (Pl::kExact) {
        mma(f[md], a, pl[0], pl[1]);  // V (p vs)_lo, then V (p vs)_hi
        mma(f[md], a, ph[0], ph[1]);
      } else {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(__uint_as_float(a[e]), ah[e], al[e]);
        mma(f[md], al, ph[0], ph[1]);  // V_lo P_hi, V_hi P_lo, V_hi P_hi
        mma(f[md], ah, pl[0], pl[1]);
        mma(f[md], ah, ph[0], ph[1]);
      }
    }
#pragma unroll
    for (int md = 0; md < kMT; ++md) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st.o[md][e] = __fadd_rn(st.o[md][e], f[md][e]);
      }
    }
  }
}

// One block per (row r0, head h): the tile of rows r0 .. r0 + len - 1 when
// r0 starts one (row_slots null: row r on slot r, every row a tile of one).
// Warp w is key group w: key tiles w, w + kNG, ... The grid is (H, rows),
// heads fastest, so every head of the first rows (the decode rows, the
// longest chains) is dispatched before the blocks of later rows, most of
// which start no tile; past 65535 rows it is (rows, H).
template <typename T, bool kScaled, int kD>
__global__ void __launch_bounds__(RowsCfg<T, kScaled, kD>::kThreads)
paged_attention_rows_kernel(const float* __restrict__ q,
                            const T* __restrict__ k_pool,
                            const T* __restrict__ v_pool,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ tables,
                            const int* __restrict__ row_slots,
                            const int* __restrict__ ctx_lens,
                            float* __restrict__ out, int n_rows, int H,
                            int d, int B, int P, int copy_bytes, int bulk,
                            float sm_scale) {
  using R = RowsCfg<T, kScaled, kD>;
  using C = typename R::C;
  constexpr int kNG = R::kNG;
  constexpr int kStages = R::kStages;
  extern __shared__ __align__(16) char smem[];
  int* s_ctx = reinterpret_cast<int*>(smem + R::kInfoAt);
  int* s_len = s_ctx + kTileRows;

  const bool heads_x = n_rows <= 65535;
  const int r0 = static_cast<int>(heads_x ? blockIdx.y : blockIdx.x);
  const int h = static_cast<int>(heads_x ? blockIdx.x : blockIdx.y);
  const int slot = row_slots != nullptr ? row_slots[r0] : r0;
  if (row_slots != nullptr && r0 % kTileRows != 0 &&
      row_slots[r0 - 1] == slot) {
    return;  // r0 continues the tile of an earlier row
  }
  const int kg = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  if (kg == 0) {
    // lane i: does row r0 + i continue the tile? The tile is the run of
    // yeses from lane 0.
    const int r = r0 + lane;
    const bool more = lane == 0 ||
        (row_slots != nullptr && lane < kTileRows && r < n_rows &&
         r % kTileRows != 0 && row_slots[r] == slot);
    const int len = __ffs(~__ballot_sync(0xffffffffu, more)) - 1;
    if (lane < kTileRows) {
      // never past the table's P pages
      s_ctx[lane] = lane < len ? max(0, min(ctx_lens[r], P * B)) : 0;
    }
    if (lane == 0) *s_len = len;
  }
  __syncthreads();
  const int len = *s_len;
  int n_keys = 0;  // the tile's largest context
#pragma unroll
  for (int i = 0; i < kTileRows; ++i) n_keys = max(n_keys, s_ctx[i]);
  const int ctx[2] = {s_ctx[2 * t], s_ctx[2 * t + 1]};
  // tiles reaching past the smallest context of the 8 rows are masked
  const int wmin = __reduce_min_sync(0xffffffffu, min(ctx[0], ctx[1]));
  const int n_kt = (n_keys + kKeys - 1) / kKeys;
  const int n_it = n_kt > kg ? (n_kt - kg + kNG - 1) / kNG : 0;
  auto tile_of = [&](int it) { return kg + it * kNG; };

  // staging: lanes 2j and 2j + 1 copy key j of the tile, alternate units
  const int sj = lane / kLanesPerKey;
  const int sub = lane % kLanesPerKey;
  const int* table = tables + static_cast<size_t>(slot) * P;
  char* ring = smem + kg * kStages * C::kBytes;
  auto key_of = [&](int it) { return tile_of(it) * kKeys + sj; };
  auto block_of = [&](int it) {
    const int key = key_of(it);
    return key < n_keys ? table[key / B] : -1;
  };
  // a stage's mbarrier (bulk copies): used once every kStages tiles
  const uint32_t bars =
      smem_u32(smem + R::kBarAt) + static_cast<uint32_t>(kg * kStages * 8);
  if (bulk && lane < kStages) mbar_init(bars + 8 * lane);
  if (bulk) fence_barrier_init();
  __syncwarp();
  auto stage = [&](int it, int blk) {
    char* base = ring + (it % kStages) * C::kBytes;
    const bool ok = blk >= 0;
    float* sc = reinterpret_cast<float*>(base + kKeys * (C::kPK + C::kPV));
    if (bulk) {
      // the tile's keys lie in one page, its rows one run of K and one of
      // V: lane 0 copies the rows some row of the tile needs (a prefix),
      // the lanes zero the rest and copy the scales
      const int k0 = tile_of(it) * kKeys;
      const int n_valid = min(kKeys, n_keys - k0);
      const int bytes = n_valid * C::kRowBytes;
      if (lane == 0) {
        const size_t off = ((static_cast<size_t>(blk) * H + h) * B +
                            k0 % B) * d;
        const uint32_t bar = bars + 8 * (it % kStages);
        mbar_expect_tx(bar, 2 * bytes);
        bulk_copy(smem_u32(base), k_pool + off, bytes, bar);
        bulk_copy(smem_u32(base + kKeys * C::kPK), v_pool + off, bytes, bar);
      }
      for (int u = bytes + 16 * lane; u < kKeys * C::kRowBytes;
           u += 16 * 32) {
        *reinterpret_cast<uint4*>(base + u) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(base + kKeys * C::kPK + u) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      if (kScaled && sub == 0) {
        const size_t at = ok ? static_cast<size_t>(blk) * H + h : 0;
        cp_async(smem_u32(sc + sj), k_scale + at, 4, ok);
        cp_async(smem_u32(sc + kKeys + sj), v_scale + at, 4, ok);
      }
      return;
    }
    const size_t off =
        ok ? ((static_cast<size_t>(blk) * H + h) * B + key_of(it) % B) * d
           : 0;
    paged::stage_row<C>(base + sj * C::kPK,
                        base + kKeys * C::kPK + sj * C::kPV,
                        kScaled ? sc + sj : nullptr, sc + kKeys + sj, k_pool,
                        v_pool, k_scale, v_scale, off,
                        ok ? static_cast<size_t>(blk) * H + h : 0, ok, sub,
                        kLanesPerKey, copy_bytes, d * C::kElem);
  };

  // the first kStages - 1 tiles: their block ids together, then the copies
  int blk_pre[kStages - 1];
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    blk_pre[p] = p < n_it ? block_of(p) : -1;
  }
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < n_it) stage(p, blk_pre[p]);
    cp_commit();
  }
  int blk_next = kStages - 1 < n_it ? block_of(kStages - 1) : -1;

  // q's B fragments (rows past the tile read as zeros), split into tf32 hi
  // and lo while the first copies are in flight: entry ks * 32 + lane holds
  // row lane / 4's dims for k-indices t and t + 4 of k-step ks
  uint4* qf = reinterpret_cast<uint4*>(smem + R::kQAt);
  for (int i = static_cast<int>(threadIdx.x); i < C::kKS * 32;
       i += R::kThreads) {
    const int row = (i & 31) >> 2;
    const int dim = paged::q_frag_dim<C>(i >> 5, i & 31);
    const float* qrow = q + (static_cast<size_t>(r0 + row) * H + h) * d;
    const float q0 = row < len && dim < d ? qrow[dim] : 0.f;
    const float q1 = row < len && dim + 1 < d ? qrow[dim + 1] : 0.f;
    uint4 v;
    split(q0, v.x, v.z);
    split(q1, v.y, v.w);
    qf[i] = v;
  }
  __syncthreads();  // q's fragments are in place

  paged::RowState<R::kMT> st;
  st.init();
  for (int it = 0; it < n_it; ++it) {
    const int nx = it + kStages - 1;  // into the buffer it - 1 freed
    if (nx < n_it) stage(nx, blk_next);
    cp_commit();
    if (nx + 1 < n_it) blk_next = block_of(nx + 1);
    if (bulk) mbar_wait(bars + 8 * (it % kStages), (it / kStages) & 1);
    cp_wait<kStages - 1>();
    __syncwarp();  // tile `it` landed, every lane's copies
    fold_tile_t<R, T, kScaled>(st, ring + (it % kStages) * C::kBytes, qf,
                               tile_of(it) * kKeys, ctx, wmin, sm_scale,
                               lane);
    if (bulk) fence_async();  // these reads before the stage's next copies
    __syncwarp();  // every lane is done with the buffer
  }
  cp_wait<0>();
  __syncthreads();  // the rings are free: they hold the merge

  // each row's sum over the 8 lanes g holding its keys
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.l[r] = __fadd_rn(st.l[r], __shfl_xor_sync(0xffffffffu, st.l[r], 4));
    st.l[r] = __fadd_rn(st.l[r], __shfl_xor_sync(0xffffffffu, st.l[r], 8));
    st.l[r] = __fadd_rn(st.l[r], __shfl_xor_sync(0xffffffffu, st.l[r], 16));
  }
  paged::merge_groups<R::kMT, kNG, true>(st, reinterpret_cast<float*>(smem),
                                         kg, 0, 1, lane);
  if (kg != 0) return;
  // row 2t + r: dims g * kD / 8 + j, j < kD / 8, in o[j / 2][r + 2 (j % 2)]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 2 * t + r;
    if (row >= len) continue;
    const float inv = __frcp_rn(st.l[r]);  // ctx 0 rows: l = 0, never read
    const bool live = ctx[r] > 0;
    float* orow = out + (static_cast<size_t>(r0 + row) * H + h) * d;
    const int d0 = g * (kD / 8);
#pragma unroll
    for (int j = 0; j < kD / 8; j += 4) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = live ? __fmul_rn(st.o[(j + i) / 2][r + 2 * ((j + i) % 2)], inv)
                    : 0.f;
      }
      if (d % 4 == 0 && d0 + j + 4 <= d) {
        *reinterpret_cast<float4*>(orow + d0 + j) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (d0 + j + i < d) orow[d0 + j + i] = v[i];
        }
      }
    }
  }
}

template <typename T, bool kScaled, int kD>
cudaError_t launch(const float* q, const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const int* row_slots,
                   const int* ctx_lens, float* out, int n_rows, int H, int d,
                   int B, int P, int copy_bytes, float sm_scale,
                   cudaStream_t st) {
  using R = RowsCfg<T, kScaled, kD>;
  auto* kernel = paged_attention_rows_kernel<T, kScaled, kD>;
  // the attribute belongs to the current device: set at every launch
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid = n_rows <= 65535
      ? dim3(static_cast<unsigned>(H), static_cast<unsigned>(n_rows))
      : dim3(static_cast<unsigned>(n_rows), static_cast<unsigned>(H));
  // bulk copies where a tile's keys lie in one page and its rows fill
  // the instantiation's width on 16-byte boundaries
  const int bulk = B % kKeys == 0 && d == kD && copy_bytes == 16;
  kernel<<<grid, R::kThreads, R::kSmem, st>>>(
      q, static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      k_scale, v_scale, tables, row_slots, ctx_lens, out, n_rows, H, d, B, P,
      copy_bytes, bulk, sm_scale);
  return cudaGetLastError();
}

template <typename T, bool kScaled>
cudaError_t launch_lane(const float* q, const void* k_pool,
                        const void* v_pool, const float* k_scale,
                        const float* v_scale, const int* tables,
                        const int* row_slots, const int* ctx_lens,
                        float* out, int n_rows, int H, int d, int B, int P,
                        float sm_scale, cudaStream_t st) {
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
  if (d <= 64) {
    return launch<T, kScaled, 64>(q, k_pool, v_pool, k_scale, v_scale,
                                  tables, row_slots, ctx_lens, out, n_rows,
                                  H, d, B, P, copy_bytes, sm_scale, st);
  }
  if (d <= 128) {
    return launch<T, kScaled, 128>(q, k_pool, v_pool, k_scale, v_scale,
                                   tables, row_slots, ctx_lens, out, n_rows,
                                   H, d, B, P, copy_bytes, sm_scale, st);
  }
  return launch<T, kScaled, kMaxHeadDim>(q, k_pool, v_pool, k_scale,
                                         v_scale, tables, row_slots,
                                         ctx_lens, out, n_rows, H, d, B, P,
                                         copy_bytes, sm_scale, st);
}

// Both entries: rows (or slots) n_rows; lane 0 float32 pools, 1 bfloat16,
// 2 int8 with scales, 3 fp8-e4m3 with scales
int launch_rows(int lane, const float* q, const void* k_pool,
                const void* v_pool, const float* k_scale,
                const float* v_scale, const int* tables,
                const int* row_slots, const int* ctx_lens, float* out,
                int n_rows, int H, int d, int B, int P, float sm_scale,
                void* stream) {
  if (n_rows <= 0 || H <= 0) return 0;  // nothing to do
  if (d < 1 || d > kMaxHeadDim || B < 1 || P < 1 || H > 65535 ||
      lane < 0 || lane > 3 ||
      static_cast<long long>(P) * B > 2147483647LL ||
      (lane >= 2 && (k_scale == nullptr || v_scale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (lane) {
    case 0:
      err = launch_lane<float, false>(q, k_pool, v_pool, k_scale, v_scale,
                                      tables, row_slots, ctx_lens, out,
                                      n_rows, H, d, B, P, sm_scale, st);
      break;
    case 1:
      err = launch_lane<__nv_bfloat16, false>(
          q, k_pool, v_pool, k_scale, v_scale, tables, row_slots, ctx_lens,
          out, n_rows, H, d, B, P, sm_scale, st);
      break;
    case 2:
      err = launch_lane<int8_t, true>(q, k_pool, v_pool, k_scale, v_scale,
                                      tables, row_slots, ctx_lens, out,
                                      n_rows, H, d, B, P, sm_scale, st);
      break;
    default:
      err = launch_lane<__nv_fp8_e4m3, true>(
          q, k_pool, v_pool, k_scale, v_scale, tables, row_slots, ctx_lens,
          out, n_rows, H, d, B, P, sm_scale, st);
      break;
  }
  return static_cast<int>(err);
}

}  // namespace

// The mixed step: q [T, H, d] fp32, tables [S, P] int32, row_slots [T] and
// ctx_lens [T] int32 (0 = masked row: zero output), out [T, H, d] fp32.
// k_scale/v_scale are [N, H] fp32 for lanes 2 and 3 and ignored otherwise.
// head_dim 1 .. 256.
extern "C" int paged_attention_mixed(
    int lane, const float* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* tables,
    const int* row_slots, const int* ctx_lens, float* out, int T, int H,
    int d, int B, int P, float sm_scale, void* stream) {
  return launch_rows(lane, q, k_pool, v_pool, k_scale, v_scale, tables,
                     row_slots, ctx_lens, out, T, H, d, B, P, sm_scale,
                     stream);
}

// The decode step: q [S, H, d] fp32, tables [S, P] int32, seq_lens [S]
// int32 (0 = inactive slot: zero row), out [S, H, d] fp32. Lanes as above.
extern "C" int paged_attention_decode(
    int lane, const float* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* tables,
    const int* seq_lens, float* out, int S, int H, int d, int B, int P,
    float sm_scale, void* stream) {
  return launch_rows(lane, q, k_pool, v_pool, k_scale, v_scale, tables,
                     nullptr, seq_lens, out, S, H, d, B, P, sm_scale,
                     stream);
}
