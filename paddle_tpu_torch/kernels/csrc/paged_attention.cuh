// Device pieces shared by the port's paged-attention kernels: the row-tile
// kernel of paged_attention.cu (the mixed step B1/B2 and the decode step
// B3/B4) and the chunk kernel of paged_attention_chunk.cu (B5/B6). Both
// stage tiles of keys of one slot's block table in shared memory by cp.async
// and fold them into tiles of query rows on the tensor cores at fp32 parity;
// they differ in how rows, keys and warps are laid out (see each file's
// notes: the chunk kernel puts 16 rows on the mma's M, the row-tile kernel
// folds transposed, keys or dims on M and 8 rows on N). What is here:
//   - Payload / mma_round: a payload element as the bits the tensor core
//     reads, and the 3xTF32 or two-product tf32 round of one k-step;
//   - Tile: the shared-memory layout of one staged tile of kKeys keys (K
//     rows, V rows, the quantized lanes' per-key scales) and the fragment
//     shapes of one payload type and head-dim capacity kD;
//   - q_frag_dim: the permuted dim order that lets one 16-byte K load feed
//     several k-steps;
//   - stage_row: one key row's K and V (and scales) by cp.async, zero-filled
//     past the real dims and for keys no row needs (src-size 0 from a valid
//     address: nothing past a row's pages is read);
//   - RowState / write_state / merge_into / merge_groups: the softmax state
//     of the two rows a lane holds, and states merged in a fixed order.
//
// Products are mma.sync m16n8k8 tf32 at fp32 parity: an fp32 operand x is
// split into tf32 hi + lo (hi by an integer add and mask, lo = x - hi
// exactly) and a product is a_lo b_hi + a_hi b_lo + a_hi b_hi (3xTF32). bf16,
// int8 and e4m3 payloads have at most 8 significant bits, exact in tf32, so
// their K and V have no lo half and those lanes run two products: S = q_hi k
// + q_lo k, O += (p vs)_hi v + (p vs)_lo v. A quantized lane's scale is
// applied outside the product, to S's columns (k_scale) and to P's columns
// before the split (v_scale), as the stored payload * scale of
// paddle_tpu/kernels/paged_attention.py:_dequant_kv up to fp32 rounding
// order. Every 8-term k-step goes into a fresh accumulator added to the
// running sum in fp32 (the tensor core's own adds truncate).
//
// Row independence: every fp32 operation on a row's path is an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn), never left
// for the compiler to contract into an FMA (it contracted the two rows a
// lane holds differently), a fully masked tile leaves a row's state as it
// was, and the merge order is fixed. So a row's bits depend only on its q,
// its context and its slot's pages, not on the other rows of its tile.
// -1e30 is the finite stand-in for -inf, so a fully masked row stays
// NaN-free; a row with context 0 writes an exact zero.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma_cp_async.cuh"

namespace paged {

constexpr float kNegInf = -1e30f;  // finite stand-in for -inf, as on the TPU
// e^x as 2^(x log2 e): the product rounds to fp32 first, so a p = e^(s - m)
// near 1 is off by ~2^-22 (ex2's own error) and a small one by ~|s - m|
// 2^-24 of itself
constexpr float kLog2e = 1.4426950408889634f;

// f[c] += A B[c] for the N column tiles c of one k-step, at fp32 parity:
// three products for an fp32 B (split here: A_lo B_hi, A_hi B_lo, A_hi
// B_hi), two for a B exact in tf32 (A_lo B, A_hi B). Each product runs
// over all N tiles before the next, so N independent chains are in flight.
template <bool kExact, int N>
__device__ __forceinline__ void mma_round(float (*f)[4],
                                          const uint32_t ahi[4],
                                          const uint32_t alo[4],
                                          const uint32_t (*b)[2]) {
  if constexpr (kExact) {
#pragma unroll
    for (int c = 0; c < N; ++c) mma(f[c], alo, b[c][0], b[c][1]);
#pragma unroll
    for (int c = 0; c < N; ++c) mma(f[c], ahi, b[c][0], b[c][1]);
  } else {
    uint32_t bh[N][2], bl[N][2];
#pragma unroll
    for (int c = 0; c < N; ++c) {
      split(__uint_as_float(b[c][0]), bh[c][0], bl[c][0]);
      split(__uint_as_float(b[c][1]), bh[c][1], bl[c][1]);
    }
#pragma unroll
    for (int c = 0; c < N; ++c) mma(f[c], alo, bh[c][0], bh[c][1]);
#pragma unroll
    for (int c = 0; c < N; ++c) mma(f[c], ahi, bl[c][0], bl[c][1]);
#pragma unroll
    for (int c = 0; c < N; ++c) mma(f[c], ahi, bh[c][0], bh[c][1]);
  }
}

__device__ __forceinline__ uint32_t f16_to_f32_bits(uint32_t h) {
  return __float_as_uint(
      __half2float(__ushort_as_half(static_cast<unsigned short>(h))));
}

// Element i of a payload run held in 32-bit words w, as the fp32 (or,
// kExact, tf32-exact) bit pattern the tensor core reads. i is a constant
// once the loops are unrolled.
template <typename T>
struct Payload;
template <>
struct Payload<float> {
  static constexpr bool kExact = false;  // split into hi + lo at the mma
  static __device__ __forceinline__ uint32_t pick(const uint32_t* w, int i) {
    return w[i];
  }
};
template <>
struct Payload<__nv_bfloat16> {
  static constexpr bool kExact = true;
  static __device__ __forceinline__ uint32_t pick(const uint32_t* w, int i) {
    return i & 1 ? w[i >> 1] & 0xffff0000u : w[i >> 1] << 16;
  }
};
template <>
struct Payload<int8_t> {
  static constexpr bool kExact = true;
  // byte b as 2^23 + (b + 128) in the mantissa, less 2^23 + 128: exact
  static __device__ __forceinline__ uint32_t pick(const uint32_t* w, int i) {
    return __float_as_uint(
        __uint_as_float(__byte_perm(w[i >> 2] ^ 0x80808080u, 0x4b000000u,
                                    0x7440 + (i & 3))) -
        8388736.f);
  }
};
template <>
struct Payload<__nv_fp8_e4m3> {
  static constexpr bool kExact = true;
  // two e4m3 bytes to f16x2 in one cvt (exact; the pair's other pick reuses
  // it), the half to fp32
  static __device__ __forceinline__ uint32_t pick(const uint32_t* w, int i) {
    uint32_t h2;
    asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n"
        : "=r"(h2)
        : "h"(static_cast<unsigned short>(w[i >> 2] >>
                                          (16 * ((i >> 1) & 1)))));
    return f16_to_f32_bits(i & 1 ? h2 >> 16 : h2 & 0xffffu);
  }
};

template <int kWords>
__device__ __forceinline__ void lds(const char* p, uint32_t* w) {
  if constexpr (kWords == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  }
}

// The shapes of one lane (payload T, kD = 64, 128 or 256 head dims,
// zero-padded past d) in shared memory and in the fragments, for a tile of
// kKeys (8, 16, 24 or 32) keys; kPad pads the rows so that no fragment load
// conflicts on a bank.
template <typename T, bool kScaled, int kD, int kKeys, bool kPad = true>
struct Tile {
  static constexpr int kElem = sizeof(T);
  static constexpr int kRowBytes = kD * kElem;
  // padded: K rows at 64 mod 128 bytes, so a quarter-warp's two rows of
  // 16-byte fragment loads fill the 32 banks; V rows at 16 mod 64, so the
  // four rows 2t of a quarter-warp (or a half-warp's 8-byte loads) do
  static constexpr int kPK =
      !kPad || kRowBytes % 128 == 64 ? kRowBytes : kRowBytes + 64;
  static constexpr int kPV = kPad ? kRowBytes + 16 : kRowBytes;
  static constexpr int kBytes =
      kKeys * (kPK + kPV) + (kScaled ? 2 * kKeys * 4 : 0);
  // S = Q K^T: a lane loads 16 bytes of a K row (kEPC dims, kEPC / 2
  // k-steps); dims (4c + t) * kEPC + 2s and + 1 are k-step c * kKSG + s's
  // k indices t and t + 4
  static constexpr int kEPC = 16 / kElem;
  static constexpr int kKSG = kEPC / 2;
  static constexpr int kKS = kD / 8;             // k-steps over d
  static constexpr int kGroups = kKS / kKSG;
  static constexpr int kNS = kKeys / 8;          // S's n-tiles (keys)
  // O += P V: lane g loads kU bytes (kEPU dims) of units g + 8j, j < kNU,
  // of each of its two V rows; n-tile nd = j * kEPU + i of O holds dims
  // (n + 8j) * kEPU + i at its column n
  static constexpr int kU = kRowBytes / 8 < 16 ? kRowBytes / 8 : 16;
  static constexpr int kEPU = kU / kElem;
  static constexpr int kNU = kRowBytes / (8 * kU);
  static constexpr int kNT = kD / 8;             // O's n-tiles
  // q's hi and lo A fragments of one 16-row warp tile
  static constexpr int kQBytes = kKS * 32 * 16 * 2;
  static_assert(kKeys % 8 == 0 && kKeys <= 32, "tiles of 8 to 32 keys");
  static_assert(kKS % kKSG == 0 && kNT % 8 == 0, "head-dim capacity");
};

// Tile row (g or g + 8 of the warp's 16) and dim of element e of k-step ks
// of q's A fragment for lane ln, in the K loads' dim order.
template <class C>
__device__ __forceinline__ int q_frag_dim(int ks, int ln) {
  return (4 * (ks / C::kKSG) + (ln & 3)) * C::kEPC + 2 * (ks % C::kKSG);
}

// One key row into a staged tile: the K row at kdst, the V row at vdst, its
// units sub * copy_bytes, + nsub * copy_bytes, ... (copy_bytes 16, 8 or 4;
// 0: byte loads, for a row or pool off a 4-byte boundary). `off` is the
// row's element offset in the pools; `ok` false (a key no row of the tile
// needs) zero-fills the row without reading it, as are the bytes past
// `real` (the dims past d). With sc_k (scaled lanes), sub 0 also copies the
// block's K and V scales (at index sc_at) to sc_k[0] and sc_v[0].
template <class C, typename T>
__device__ __forceinline__ void stage_row(
    char* kdst, char* vdst, float* sc_k, float* sc_v,
    const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    size_t off, size_t sc_at, bool ok, int sub, int nsub, int copy_bytes,
    int real) {
  const char* ksrc = reinterpret_cast<const char*>(k_pool + off);
  const char* vsrc = reinterpret_cast<const char*>(v_pool + off);
  if (copy_bytes > 0) {
    for (int u = sub * copy_bytes; u < C::kRowBytes;
         u += nsub * copy_bytes) {
      const bool in = ok && u < real;
      cp_async(smem_u32(kdst + u),
               in ? ksrc + u : reinterpret_cast<const char*>(k_pool),
               copy_bytes, in);
      cp_async(smem_u32(vdst + u),
               in ? vsrc + u : reinterpret_cast<const char*>(v_pool),
               copy_bytes, in);
    }
  } else {  // a pool off a 4-byte boundary: byte loads
    for (int u = sub; u < C::kRowBytes; u += nsub) {
      const bool in = ok && u < real;
      kdst[u] = in ? ksrc[u] : 0;
      vdst[u] = in ? vsrc[u] : 0;
    }
  }
  if (sc_k != nullptr && sub == 0) {
    cp_async(smem_u32(sc_k), k_scale + sc_at, 4, ok);
    cp_async(smem_u32(sc_v), v_scale + sc_at, 4, ok);
  }
}

// The softmax state of the two rows a lane holds (rows g and g + 8 of a
// 16-row warp tile in the chunk kernel, rows 2t and 2t + 1 of an 8-row
// tile in the row-tile kernel): O's accumulator fragments, the running
// max, and this lane's share of the row sum (reduced over the lanes that
// share the row once, at the end).
template <int kNT>
struct RowState {
  float o[kNT][4];
  float m[2];
  float l[2];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int nd = 0; nd < kNT; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
    }
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }
};

// Floats one state takes in a merge's scratch, per lane: m, l, then O
template <int kNT>
__host__ __device__ constexpr int merge_vals() {
  return 4 + 4 * kNT;
}

// This lane's state into p[v * 32] (p: the scratch plus the lane), value v
// as merge_into reads it
template <int kNT>
__device__ __forceinline__ void write_state(const RowState<kNT>& st,
                                            float* p) {
  p[0] = st.m[0];
  p[32] = st.m[1];
  p[64] = st.l[0];
  p[96] = st.l[1];
#pragma unroll
  for (int nd = 0; nd < kNT; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) p[(4 + 4 * nd + e) * 32] = st.o[nd][e];
  }
}

// Merge states 1 .. n - 1 (value v of state k is get(k, v), laid out as
// write_state's) into st, state 0, in order: m_all the largest max; st
// rescaled by e^(m_0 - m_all), then each state k added at e^(m_k - m_all)
// (0 for a state that saw no key of the row); st's max becomes m_all, so
// the result can be merged again. Every state's l is already summed over
// the lanes holding its row. Element e of an O fragment belongs to row
// e >> 1 (the quad layout: rows g and g + 8), or with kRowBit0 to row
// e & 1 (the row-tile kernel's transposed layout: rows 2t and 2t + 1).
template <int kNT, bool kRowBit0 = false, class Get>
__device__ __forceinline__ void merge_into(RowState<kNT>& st, int n,
                                           Get get) {
  constexpr int kShift = kRowBit0 ? 0 : 1;
  float m_all[2] = {st.m[0], st.m[1]};
  for (int k = 1; k < n; ++k) {
    m_all[0] = fmaxf(m_all[0], get(k, 0));
    m_all[1] = fmaxf(m_all[1], get(k, 1));
  }
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    f[r] = expf(__fsub_rn(st.m[r], m_all[r]));
    st.l[r] = __fmul_rn(st.l[r], f[r]);
  }
#pragma unroll
  for (int nd = 0; nd < kNT; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      st.o[nd][e] = __fmul_rn(st.o[nd][e], f[(e >> kShift) & 1]);
    }
  }
  for (int k = 1; k < n; ++k) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // 0 for a state that saw no key of the row
      f[r] = expf(__fsub_rn(get(k, r), m_all[r]));
      st.l[r] = __fadd_rn(st.l[r], __fmul_rn(get(k, 2 + r), f[r]));
    }
#pragma unroll
    for (int nd = 0; nd < kNT; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st.o[nd][e] = __fadd_rn(
            st.o[nd][e],
            __fmul_rn(get(k, 4 + 4 * nd + e), f[(e >> kShift) & 1]));
      }
    }
  }
  st.m[0] = m_all[0];
  st.m[1] = m_all[1];
}

// Merge kGroups key groups' states (after quad_sum) into group 0's, in
// group order (merge_into). Group kg of warp-row `slot` (of nslots) writes
// through mrg ((kGroups - 1) * nslots * merge_vals * 32 floats); the whole
// block passes the barrier inside. Only kg == 0 holds the result.
template <int kNT, int kGroups, bool kRowBit0 = false>
__device__ __forceinline__ void merge_groups(RowState<kNT>& st, float* mrg,
                                             int kg, int slot, int nslots,
                                             int lane) {
  if constexpr (kGroups > 1) {
    constexpr int kVals = merge_vals<kNT>();
    if (kg > 0) {
      write_state(st, mrg + ((kg - 1) * nslots + slot) * kVals * 32 + lane);
    }
    __syncthreads();
    if (kg == 0) {
      merge_into<kNT, kRowBit0>(st, kGroups, [&](int k, int v) {
        return mrg[(((k - 1) * nslots + slot) * kVals + v) * 32 + lane];
      });
    }
  }
}

}  // namespace paged
