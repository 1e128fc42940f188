// Two-pass flash attention with exact static-delta quantization of the
// normalized softmax: kernels B2 and B3 of the port, and P.
//
// Replaces, by function:
//   B2  qdiffusion_tpu/ops/pallas/flash_attention.py::flash_attention
//       (pallas_call :170, kernel body `_kernel` :87-135);
//   B3  qdiffusion_tpu/ops/pallas/flash_streaming.py::streaming_flash_attention
//       (pallas_calls :153 and :165, `_p1_kernel` / `_p2_kernel`);
//   P   scripts/bench_flash_epilogue.py::flash (pallas_call :77, `_kernel`
//       :23-60): B2's softmax . V with one of nine epilogues, delta = 1/255.
// The wrappers are qdiffusion_torch/ops/flash_attention.py and
// qdiffusion_torch/ops/flash_streaming.py, which call qdt_flash_attention
// and differ only in the switches it selects, and
// qdiffusion_torch/ops/flash_epilogue.py, which calls qdt_flash_epilogue.
//
// The function, per (batch, head) and query row, over S keys:
//   s   = (q . k) * scale                   f32 (bf16 operands, f32 sums)
//   m,l = row max, sum exp(s - m)
//   e   = exp(s - m)
//   B2 without sm_q:  o = (bf16(e) . v) * (1/l)     normalise after PV
//   otherwise:        p = e * (1/l); p = bf16(p) (bf16 inputs);
//                     p = fq(p) (sm_q); o = bf16(p) . v
// V arrives already fake-quantized (the wrappers hoist it, as the TPU
// wrappers do). f32 inputs keep f32 accuracy: every product is taken in
// 3xTF32 (below), nothing is rounded to bf16. P's modes replace the
// `otherwise` line by its own transforms of p (`epilogue` below; the port's
// ops/flash_epilogue.py lists them).
//
// fq is the TPU kernels' `_fq` (flash_attention.py:61-84): it multiplies by
// 1/delta, rounds half to even (rintf), and has three clip branches
// (symmetric; nonneg and always_zero: upper clip only; otherwise [0, n-1]).
//
// Three designs share this file, all mma.sync with the scores in registers
// and a cp.async ring of K/V blocks; qdt_flash_attention picks by dtype and
// head dim D (at most 512):
//   flash_mma_kernel   bf16, D <= 128: every B2 site of the SD fold path,
//                      B3 at D <= 128, and P (D <= 48);
//   flash_tf32_kernel  f32, D <= 128: B2 on the stream engine's f32 path
//                      and on the f32 sim path, B3 at D <= 128;
//   flash_wide_kernel  128 < D <= 512, bf16 and f32: B3 at the VAE's
//                      D = 512 (bf16 on the fold path, f32 on the stream
//                      path), B2 at such D.
//
// flash_mma_kernel, the Hopper design. One block of 4 warps per (64 query
// rows, batch*head); each warp owns 16 rows. Q is staged once through
// shared memory into registers as mma.sync.m16n8k16 bf16 A-fragments
// (ldmatrix); D is zero-padded to a multiple of 16 (40 -> 48) in shared
// memory only. K/V blocks of 64 keys stream through a ring of two shared
// stages by cp.async (16-byte copies, zero-fill past S), rows padded by 16
// bytes so that ldmatrix (.trans for V) reads without bank conflicts. The
// 16 x 64 score tile of a warp is an f32 accumulator fragment in registers
// and never touches shared memory; row max and sum reduce over the 4 lanes
// of a quad. e = ex2.approx(s * scale * log2 e - m') is one FFMA and one
// MUFU op (m' is the row max of s * scale * log2 e). p is packed from the
// C-fragment straight into the A-fragments of the PV mma (FlashAttention-2's
// register reuse), and the f32 output (16 x D per warp) stays in registers
// until one masked store. Pass structure keeps the TPU function exactly
// (every p uses the row's final max and sum; no online rescaling of a
// bf16-rounded e):
//   normalise after PV (B2 without sm_q, P's fp_postnorm): pass 1 is QK^T
//     and the row max only, no exponential; pass 2 forms e, l += e and
//     acc += bf16(e) . v, then o = acc * (1/l): one exponential per score;
//   normalise first (sm_q, B3, P's other modes): pass 1 keeps the online
//     (max, sum-exp) per lane, merged over the quad at its end; pass 2 forms
//     p = e * (1/l) and the epilogue: two exponentials per score.
// Epi, a compile-time switch, selects the epilogue: B2's and B3's three
// functions and P's nine modes are one kernel body. D is a template
// class (<= 32, 48, 64, 80, 128) so that Q, S and O fragments are
// register arrays. B2's and B3's epilogues exist at every class, P's modes
// at the 48 class of P's one shape (D = 40) only: 22 instances in all.
// What bounds it on an H100: at the SD shapes the MUFU exponentials (16 per
// clock per SM: 0.26 ms per (8, 4096, 8, 40) call at one per score) and,
// close behind, the three mma.sync passes over padded D (QK^T twice, PV
// once: about 0.26 ms at the dense bf16 peak, which mma.sync does not
// reach). wgmma is left to a later redesign if the tensor cores set the pace.
//
// flash_tf32_kernel, f32 at D <= 128: flash_mma_kernel's layout (4 warps x
// 16 query rows, 64-key blocks in a two-stage cp.async ring, scores, p and
// output in registers) on mma.sync.m16n8k8 TF32. TF32 alone keeps 11 bits,
// so each f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// and a product is lo.hi + hi.lo + hi.hi in f32 (3xTF32): about 2^-22 of
// each product, near f32's own rounding. tf32() rounds as cvt.rna does, by
// an integer add and mask (cvt.rna.tf32.f32 lowers to a longer sequence,
// about a fifth more kernel time on an H100 80GB HBM3 by bench_flash's
// `split_cvt` variant). Two layouts make
// the fragments fit without shuffles: the contraction index of each 8-deep
// step is read in pair order (A column t is depth 2t, column t + 4 is depth
// 2t + 1, the same for K), so a lane loads its two values as one float2;
// and the score C-fragment (keys 2t, 2t + 1 of a lane) is the PV A-fragment
// under the same pair order of keys, with V's B-fragment read at rows 2t
// and 2t + 1. Row strides are 8 or 24 (mod 32) words for Q and K (float2
// reads) and 4 (mod 8) for V (column reads), so no read meets a bank
// conflict. Q's hi and lo fragments stay in registers for D <= 80 and are
// read again from shared memory per block above that. With f32 inputs and
// no sm_q nothing is rounded between the exponential and PV, so
// o = (e . v) * (1/l) does not depend on the shift m beyond f32 rounding:
// one pass with FlashAttention-2's online rescale (o and l scaled by
// exp(m_old - m_new) when the row max grows) serves B2 and B3 alike, one
// exponential per score and K/V read once. With sm_q, p = e * (1/l) must
// be exact before fq, so two passes as above. What bounds it: instruction
// slots, shared by the three TF32 mma per product and the splits of every
// K and V fragment, which each warp makes anew (bench_flash's variants on
// an H100 80GB HBM3: one mma a product runs in 45 % of the time, no split
// in 76 %).
//
// flash_wide_kernel, 128 < D <= 512 (D classes 256 and 512, zero-padded in
// shared memory): no warp can hold 16 rows of output at D = 512 beside its
// scores (64 query rows of f32 output are 128 KB), so the output is split
// over warps along D. A block of 8 warps takes BM query rows: bf16 64 rows,
// f32 32 rows (shared memory holds 32 f32 rows of Q at D = 512 beside two
// K/V slots). For the scores, warp (row group g of 16 rows, split j) takes
// its rows over the j-th part of each key block (BN = 64 keys bf16, 32
// f32; bf16: 4 row groups x 2 splits, contracting over the whole D from Q
// in shared memory; f32: 2 x 4, each warp contracting the whole key block
// over a quarter of D with an accumulator per 8-deep step, the quarters
// added in a fixed order through shared memory, so that each K fragment's
// split serves four key tiles and the tensor cores' accumulation error
// stays that of one step). It writes p (bf16 or f32) into a shared
// (BM, BN) tile, and after one barrier each warp takes o[32 rows, a part of
// D] += p . V, two 16-row tiles so that each V fragment serves two mma,
// with its part of the output in registers (bf16: 128 f32 a thread at
// D = 512; f32: 64). Steps stream one block each through a ring of two
// slots: pass 1 reads K blocks and keeps each lane's online (max, sum-exp)
// (the row max alone for B2 without sm_q); the warps' statistics meet
// once, through shared memory, at the end of pass 1; pass 2 reads K and V
// blocks in turn (scores and p of block j, then PV of block j), so one
// block's PV overlaps the next block's copy. e = ex2(s * c - m') in one
// FFMA from the raw score. bf16 products are m16n8k16 with ldmatrix, f32
// products 3xTF32 as in flash_tf32_kernel. The function is kept as
// flash_mma_kernel keeps it, two passes in every mode (B3's
// bf16(e * (1/l)) needs the row's final max and sum; at D = 512 there is
// one exponential per 512 MACs, so the second QK^T pass costs tensor work,
// not MUFU time). What bounds it: shared-memory fragment reads (a warp
// reads its Q rows and its keys at every block; bench_flash's variants on
// an H100 80GB HBM3 that leave out the QK^T or the PV mma save only 6 % or
// 1 %) and the L2 traffic of K twice and V once per BM query rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float kNegBig = -1e30f;  // masked scores (flash_streaming.py:39)

__device__ __forceinline__ float fq(float x, float delta, float inv_delta,
                                    float zp, int n_levels, int symmetric,
                                    int always_zero) {
  float xi = rintf(x * inv_delta);
  if (!always_zero) xi += zp;
  float xq;
  if (symmetric) {
    xq = fminf(fmaxf(xi, (float)(-n_levels - 1)), (float)n_levels);
  } else if (always_zero) {  // softmax probabilities are >= 0
    xq = fminf(xi, (float)(n_levels - 1));
  } else {
    xq = fminf(fmaxf(xi, 0.f), (float)(n_levels - 1));
  }
  return always_zero ? xq * delta : (xq - zp) * delta;
}

// -- flash_mma_kernel: bf16, D <= 128 ----------------------------------------

namespace mmad {

constexpr int kWarpsM = 4;             // warps per block, 16 query rows each
constexpr int kRows = 16 * kWarpsM;    // query rows per block
constexpr int kThreadsM = 32 * kWarpsM;
constexpr int kKeys = 64;              // keys per K/V block
constexpr int kStages = 2;             // K/V ring depth
constexpr int kPClass = 3;             // P's D class: D <= 48 (P has D = 40)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -__builtin_huge_valf();
// P's delta (bench_flash_epilogue.py:75: 1/255 in f32) and its f32
// reciprocal, as the TPU kernel forms it (`inv_d = 1.0 / d`, :33)
constexpr float kDelta = 1.0f / 255.0f;
constexpr float kInvDelta = 1.0f / kDelta;

// The epilogue: P's nine modes in P's order (bench_flash_epilogue.py:118-119),
// then B2's and B3's softmax quantizer. B2 without sm_q is kPostNorm, B3
// without it kCastRt.
enum Epi : int {
  kPostNorm = 0,  // (bf16(e) . v) * (1/l)
  kPreNorm,       // p = e * (1/l)
  kCastRt,        // bf16(p)
  kMulOnly,       // p * inv_d
  kFloorHalf,     // floor(p * inv_d + 0.5)
  kRoundOnly,     // round(p * inv_d), half to even
  kRoundClip,     // min(round(p * inv_d), 255)
  kFull,          // min(round(p * inv_d), 255) * d
  kFullFloor,     // min(floor(p * inv_d + 0.5), 255) * d
  kSmq,           // fq(bf16(p)) with the device quantizer [delta, zp]
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const float* sm;  // device [delta, zero_point] (kSmq only)
  int T, S, H, D;
  int vec;          // 1: rows copy as 16-byte cp.async chunks
  float scale;
  int n_levels, symmetric, always_zero;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes from device memory into shared memory; bytes = 0 zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two f32 to one register of bf16 (lo in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// p = e * (1/l) to the value fed to the PV product (before its bf16
// rounding). Products that an add follows use __fmul_rn, so that no FMA
// contraction changes the rounding against the plain version.
template <int EPI>
__device__ __forceinline__ float epilogue(float pn, float delta,
                                          float inv_delta, float zp,
                                          const Params& p) {
  if constexpr (EPI == kPreNorm || EPI == kCastRt) {
    return pn;  // rounded to bf16 when packed
  } else if constexpr (EPI == kMulOnly) {
    return pn * kInvDelta;
  } else if constexpr (EPI == kFloorHalf) {
    return floorf(__fadd_rn(__fmul_rn(pn, kInvDelta), 0.5f));
  } else if constexpr (EPI == kRoundOnly) {
    return rintf(pn * kInvDelta);
  } else if constexpr (EPI == kRoundClip) {
    return fminf(rintf(pn * kInvDelta), 255.f);
  } else if constexpr (EPI == kFull) {
    return fminf(rintf(pn * kInvDelta), 255.f) * kDelta;
  } else if constexpr (EPI == kFullFloor) {
    return fminf(floorf(__fadd_rn(__fmul_rn(pn, kInvDelta), 0.5f)), 255.f) *
           kDelta;
  } else {  // kSmq: bf16 round trip first (TPU flash_attention.py:126-129)
    return fq(__bfloat162float(__float2bfloat16(pn)), delta, inv_delta, zp,
              p.n_levels, p.symmetric, p.always_zero);
  }
}

// rows [row0, row0 + ROWS) of one (b, h) slice of a (B, L, H, D) tensor
// into a (ROWS, LDS) shared tile: 16-byte cp.async chunks (zero-filled past
// L) when `vec`, else element copies. Columns D..DP were zeroed once and
// stay so.
template <int ROWS, int LDS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int L, const Params& p) {
  const size_t stride = (size_t)p.H * p.D;
  if (p.vec) {
    const int nc = p.D >> 3;
    for (int idx = threadIdx.x; idx < ROWS * nc; idx += kThreadsM) {
      const int r = idx / nc, c = idx - r * nc;
      const int t = row0 + r;
      const bool in = t < L;
      cp_async16(smem_u32(dst + r * LDS + c * 8),
                 src + (in ? (size_t)t * stride + c * 8 : 0), in ? 16 : 0);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < ROWS * p.D; idx += kThreadsM) {
    const int r = idx / p.D, d = idx - r * p.D;
    const int t = row0 + r;
    dst[r * LDS + d] = t < L ? src[(size_t)t * stride + d]
                             : __float2bfloat16(0.f);
  }
}

template <int KD, int EPI>
__global__ void __launch_bounds__(kThreadsM)
    flash_mma_kernel(const Params p) {
  constexpr int DP = 16 * KD;        // padded head dim
  constexpr int LDS = DP + 8;        // shared row stride: 16 bytes of pad
  constexpr int ND = DP / 8;         // 8-wide output column tiles
  constexpr int TILE = kKeys * LDS;  // elements of one K or V tile
  constexpr bool kAfter = EPI == kPostNorm;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // (kRows, LDS)
  bf16* Ks = Qs + kRows * LDS;      // [kStages][TILE]
  bf16* Vs = Ks + kStages * TILE;   // [kStages][TILE]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane & 3;        // column pair within an 8-wide tile
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int t0 = blockIdx.x * kRows;
  const size_t hd = (size_t)h * p.D;
  const bf16* qb = p.q + (size_t)b * p.T * p.H * p.D + hd;
  const bf16* kb = p.k + (size_t)b * p.S * p.H * p.D + hd;
  const bf16* vb = p.v + (size_t)b * p.S * p.H * p.D + hd;
  bf16* ob = p.o + (size_t)b * p.T * p.H * p.D + hd;

  {  // zero every tile once: the pad columns D..DP then stay zero
    constexpr int n16 = (kRows * LDS + 2 * kStages * TILE) * 2 / 16;
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    for (int i = threadIdx.x; i < n16; i += kThreadsM)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // steps 0..nb-1 are pass 1 (K blocks), nb..2nb-1 pass 2 (K and V)
  const int nb = (p.S + kKeys - 1) / kKeys;
  const int steps = 2 * nb;
  auto load_step = [&](int i) {
    const int st = i % kStages;
    const int s0 = (i < nb ? i : i - nb) * kKeys;
    load_rows<kKeys, LDS>(Ks + st * TILE, kb, s0, p.S, p);
    if (i >= nb) load_rows<kKeys, LDS>(Vs + st * TILE, vb, s0, p.S, p);
  };
  load_rows<kRows, LDS>(Qs, qb, t0, p.T, p);  // in step 0's group
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps) load_step(i);
    cp_commit();
  }

  float delta = 0.f, inv_delta = 0.f, zp = 0.f;
  if constexpr (EPI == kSmq) {
    delta = p.sm[0];
    zp = p.sm[1];
    inv_delta = 1.f / delta;
  }
  const float c = p.scale * kLog2e;
  // per lane: rows g = lane / 4 (r = 0) and g + 8 (r = 1) of the warp
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f}, linv[2] = {0.f, 0.f};
  uint32_t qa[KD][4];
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    if (i + kStages - 1 < steps) load_step(i + kStages - 1);
    cp_commit();
    cp_wait<kStages - 1>();  // step i's group has landed
    __syncthreads();
    if (i == 0) {  // Q A-fragments: matrices (rows 0-7 | 8-15) x (k | k+8)
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qa[kk], smem_u32(Qs + (warp * 16 + (lane & 15)) * LDS +
                                 kk * 16 + (lane >> 4) * 8));
    }
    const int st = i % kStages;
    const bool pass2 = i >= nb;
    const int s0 = (pass2 ? i - nb : i) * kKeys;
    const bf16* K = Ks + st * TILE;

    // s (16 x 64 per warp) = Q . K^T: two 8-key tiles per ldmatrix.x4
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t kf[4];
        ldsm_x4(kf, smem_u32(K + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) *
                                     LDS +
                             kk * 16 + ((lane >> 3) & 1) * 8));
        mma16816(s[j], qa[kk], kf[0], kf[1]);
        mma16816(s[j + 1], qa[kk], kf[2], kf[3]);
      }
    }
    // columns past S (TPU :101-103) exist in the last block only: the
    // other blocks skip the mask
    const bool ragged = s0 + kKeys > p.S;
    auto mask = [&](float value) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (s0 + j * 8 + quad * 2 + (e & 1) >= p.S) s[j][e] = value;
    };
    if (!pass2) {  // u = s * scale * log2 e in place of s, -inf past S
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= c;
      if (ragged) mask(kNegInf);
      if constexpr (kAfter) {  // the row max only
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
      } else {  // this lane's online (max, sum-exp)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m[r];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            sum += ex2(s[j][2 * r] - mx) + ex2(s[j][2 * r + 1] - mx);
          l[r] = l[r] * ex2(m[r] - mx) + sum;
          m[r] = mx;
        }
      }
    } else {
      if (i == nb) {  // pass 1 done: merge the quad's lanes
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m[r];
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          if constexpr (!kAfter) {
            float sum = l[r] * ex2(m[r] - mx);
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            linv[r] = 1.f / sum;
            l[r] = 0.f;
          }
          m[r] = mx;
        }
      }
      // e = exp(s * scale - m) = ex2(s * c - m'): one FFMA, one MUFU op;
      // e, then p, in place of s; e = 0 past S
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = ex2(fmaf(s[j][e], c, -m[e >> 1]));
      if (ragged) mask(0.f);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          if constexpr (kAfter) {
            l[r] += s[j][e];
          } else {
            s[j][e] = epilogue<EPI>(s[j][e] * linv[r], delta, inv_delta, zp,
                                    p);
          }
        }
      // PV: the C-fragments of key tiles (2kc, 2kc+1) are the A-fragment
      // of key chunk kc
      const bf16* V = Vs + st * TILE;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                          pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                          pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                          pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int jd = 0; jd < ND; jd += 2) {
          uint32_t vf[4];
          ldsm_x4_t(vf, smem_u32(V + (kc * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * LDS +
                                 jd * 8 + (lane >> 4) * 8));
          mma16816(o[jd], pa, vf[0], vf[1]);
          mma16816(o[jd + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // the next step's loads refill this stage
  }

  if constexpr (kAfter) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      linv[r] = 1.f / sum;
    }
  }
  const size_t stride = (size_t)p.H * p.D;
  const bool pairs = (p.D & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + warp * 16 + (lane >> 2) + 8 * r;
    if (t >= p.T) continue;
    bf16* orow = ob + (size_t)t * stride;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
      const int d = jd * 8 + quad * 2;
      float v0 = o[jd][2 * r], v1 = o[jd][2 * r + 1];
      if constexpr (kAfter) {
        v0 *= linv[r];
        v1 *= linv[r];
      }
      if (pairs && d + 1 < p.D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (d < p.D) orow[d] = __float2bfloat16(v0);
        if (d + 1 < p.D) orow[d + 1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int KD, int EPI>
int launch_kd(const Params& p, int B, int H, cudaStream_t st) {
  constexpr int smem = (kRows + 2 * kStages * kKeys) * (16 * KD + 8) * 2;
  auto kern = flash_mma_kernel<KD, EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((p.T + kRows - 1) / kRows, B * H), kThreadsM, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// the D class: the smallest of 32, 48, 64, 80, 128 that holds D
template <int EPI>
int launch_d(const Params& p, int B, int H, cudaStream_t st) {
  if (p.D <= 32) return launch_kd<2, EPI>(p, B, H, st);
  if (p.D <= 48) return launch_kd<3, EPI>(p, B, H, st);
  if (p.D <= 64) return launch_kd<4, EPI>(p, B, H, st);
  if (p.D <= 80) return launch_kd<5, EPI>(p, B, H, st);
  return launch_kd<8, EPI>(p, B, H, st);
}

// B2's and B3's three epilogues, at every D class
int launch_epi(const Params& p, int epi, int B, int H, cudaStream_t st) {
  switch (epi) {
    case kPostNorm: return launch_d<kPostNorm>(p, B, H, st);
    case kCastRt: return launch_d<kCastRt>(p, B, H, st);
    case kSmq: return launch_d<kSmq>(p, B, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// P's nine modes, at the one D class of P's shape (D <= 48)
int launch_p(const Params& p, int mode, int B, int H, cudaStream_t st) {
  if (p.D > 16 * kPClass) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kPostNorm: return launch_kd<kPClass, kPostNorm>(p, B, H, st);
    case kPreNorm: return launch_kd<kPClass, kPreNorm>(p, B, H, st);
    case kCastRt: return launch_kd<kPClass, kCastRt>(p, B, H, st);
    case kMulOnly: return launch_kd<kPClass, kMulOnly>(p, B, H, st);
    case kFloorHalf: return launch_kd<kPClass, kFloorHalf>(p, B, H, st);
    case kRoundOnly: return launch_kd<kPClass, kRoundOnly>(p, B, H, st);
    case kRoundClip: return launch_kd<kPClass, kRoundClip>(p, B, H, st);
    case kFull: return launch_kd<kPClass, kFull>(p, B, H, st);
    case kFullFloor: return launch_kd<kPClass, kFullFloor>(p, B, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v, void* o,
                   int T, int S, int H, int D, float scale) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.sm = nullptr;
  p.T = T;
  p.S = S;
  p.H = H;
  p.D = D;
  p.scale = scale;
  p.n_levels = p.symmetric = p.always_zero = 0;
  // 16-byte chunks: D a multiple of 8 and every row start aligned
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  p.vec = D % 8 == 0 && addr % 16 == 0;
  return p;
}

}  // namespace mmad

// -- shared by flash_tf32_kernel and flash_wide_kernel -----------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const float* sm;  // device [delta, zero_point] (sm_q only)
  int T, S, H, D;
  int vec;          // 1: rows copy as 16-byte cp.async chunks
  float scale;
  int n_levels, symmetric, always_zero;
};

template <typename T>
__device__ __forceinline__ T zero_of() {
  if constexpr (std::is_same<T, float>::value) {
    return 0.f;
  } else {
    return __float2bfloat16(0.f);
  }
}

// rows [row0, row0 + ROWS) of one (b, h) slice of a (B, L, H, D) tensor
// into a (ROWS, LD) shared tile: 16-byte cp.async chunks (zero-filled past
// L) when `vec`, else element copies. Columns past D are left as they are.
// The chunks walk the padded width DP, a compile-time constant, so that a
// chunk's row and column take no integer division.
template <typename T, int ROWS, int LD, int DP, int NTHR>
__device__ __forceinline__ void load_rows_x(T* dst, const T* src, int row0,
                                            int L, const Args& p) {
  constexpr int E = 16 / sizeof(T), NC = DP / E;
  const size_t stride = (size_t)p.H * p.D;
  if (p.vec) {
    for (int idx = threadIdx.x; idx < ROWS * NC; idx += NTHR) {
      const int r = idx / NC, c = idx - r * NC;
      const int t = row0 + r;
      const bool in = t < L;
      if (c * E < p.D)
        mmad::cp_async16(mmad::smem_u32(dst + r * LD + c * E),
                         src + (in ? (size_t)t * stride + c * E : 0),
                         in ? 16 : 0);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < ROWS * p.D; idx += NTHR) {
    const int r = idx / p.D, d = idx - r * p.D;
    const int t = row0 + r;
    dst[r * LD + d] = t < L ? src[(size_t)t * stride + d] : zero_of<T>();
  }
}

// tf32(x), rounded to nearest with ties away from zero as cvt.rna.tf32.f32
// rounds finite x: half an ulp of the 10-bit mantissa added to the
// magnitude, the 13 low bits cleared. Two integer ops; cvt.rna lowers to
// a longer compare-and-select sequence on sm_90.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 2^-22 of |x|: hi = tf32(x), lo = tf32(x - hi)
// (x - hi is exact in f32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c (16 x 8 f32) += a (16 x 8 tf32, row) . b (8 x 8 tf32, col)
__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32, the small cross terms first; b = {hi0, hi1, lo0, lo1}
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&b)[4]) {
  mma1688(c, al, b[0], b[1]);
  mma1688(c, ah, b[2], b[3]);
  mma1688(c, ah, b[0], b[1]);
}

// the same into a fresh accumulator, then added to c in f32: the tensor
// cores' accumulation error stays that of one 8-deep step, and c's sum is
// rounded to nearest
__device__ __forceinline__ void mma3_add(float (&c)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const uint32_t (&b)[4]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(t, ah, al, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// The A-fragment (rows r0 + g, r0 + g + 8) of a row-major f32 tile at depth
// k0, in pair order (column t is depth k0 + 2t, t + 4 is k0 + 2t + 1),
// split into hi and lo
template <int LD>
__device__ __forceinline__ void load_a_tf32(uint32_t (&h)[4], uint32_t (&l)[4],
                                            const float* tile, int r0, int k0,
                                            int lane) {
  const float* base = tile + (r0 + (lane >> 2)) * LD + k0 + 2 * (lane & 3);
  const float2 x0 = *reinterpret_cast<const float2*>(base);
  const float2 x1 = *reinterpret_cast<const float2*>(base + 8 * LD);
  split_tf32(x0.x, h[0], l[0]);
  split_tf32(x1.x, h[1], l[1]);
  split_tf32(x0.y, h[2], l[2]);
  split_tf32(x1.y, h[3], l[3]);
}

// The B-fragment of K^T at depth k0: column g is key row n0 + g of a
// row-major tile, depth in pair order
template <int LD>
__device__ __forceinline__ void load_bk_tf32(uint32_t (&b)[4],
                                             const float* tile, int n0,
                                             int k0, int lane) {
  const float2 x = *reinterpret_cast<const float2*>(
      tile + (n0 + (lane >> 2)) * LD + k0 + 2 * (lane & 3));
  split_tf32(x.x, b[0], b[2]);
  split_tf32(x.y, b[1], b[3]);
}

// The B-fragment of V over keys k0.. in pair order (rows k0 + 2t and
// k0 + 2t + 1), column n0 + g
template <int LD>
__device__ __forceinline__ void load_bv_tf32(uint32_t (&b)[4],
                                             const float* tile, int n0,
                                             int k0, int lane) {
  const float* x = tile + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  split_tf32(x[0], b[0], b[2]);
  split_tf32(x[LD], b[1], b[3]);
}

// B2's and B3's softmax value fed to PV, from pn = e * (1/l): fq under sm_q
// (after the bf16 round trip for bf16 inputs, TPU flash_attention.py:126-129),
// else pn (rounded to bf16 when packed, for bf16 inputs)
template <int EPI, bool BF>
__device__ __forceinline__ float b23_epilogue(float pn, float delta,
                                              float inv_delta, float zp,
                                              const Args& p) {
  if constexpr (EPI == mmad::kSmq) {
    if constexpr (BF) pn = __bfloat162float(__float2bfloat16(pn));
    return fq(pn, delta, inv_delta, zp, p.n_levels, p.symmetric,
              p.always_zero);
  } else {
    return pn;
  }
}

// -- flash_tf32_kernel: f32, D <= 128 ----------------------------------------

namespace tf32 {

constexpr int kRows = 64;  // 4 warps x 16 query rows
constexpr int kThreads = 128;
constexpr int kKeys = 64;  // keys per K/V block
constexpr int kStages = 2;

// Q and K rows: float2 reads by 8 rows x 4 lanes want a stride of 8 or 24
// (mod 32) words; V rows: column reads at rows 2t, 2t + 1 want 4 (mod 8)
template <int DP>
__host__ __device__ constexpr int ldk() {
  return DP % 16 == 0 ? DP + 8 : DP;
}
template <int DP>
__host__ __device__ constexpr int ldv() { return DP + 4; }
template <int DP>
__host__ __device__ constexpr int smem_bytes() {
  return 4 * (kRows * ldk<DP>() + kStages * kKeys * (ldk<DP>() + ldv<DP>()));
}

// SMQ: two passes (pass 1 the online statistics, pass 2 p = fq(e * (1/l))
// and PV); else one pass with the online rescale, o = (e . v) * (1/l)
template <int DP, bool SMQ>
__global__ void __launch_bounds__(kThreads)
    flash_tf32_kernel(const Args p) {
  constexpr int KD = DP / 8;  // 8-deep steps of QK^T, 8-wide output tiles
  constexpr int LDK = ldk<DP>(), LDV = ldv<DP>();
  constexpr int KT = kKeys * LDK, VT = kKeys * LDV;
  constexpr bool kQReg = DP <= 80;  // Q's hi/lo fragments in registers
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // (kRows, LDK)
  float* Ks = Qs + kRows * LDK;                    // [kStages][KT]
  float* Vs = Ks + kStages * KT;                   // [kStages][VT]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int r0 = warp * 16;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int t0 = blockIdx.x * kRows;
  const size_t hd = (size_t)h * p.D;
  const float* qb = static_cast<const float*>(p.q) +
                    (size_t)b * p.T * p.H * p.D + hd;
  const float* kb = static_cast<const float*>(p.k) +
                    (size_t)b * p.S * p.H * p.D + hd;
  const float* vb = static_cast<const float*>(p.v) +
                    (size_t)b * p.S * p.H * p.D + hd;
  float* ob = static_cast<float*>(p.o) + (size_t)b * p.T * p.H * p.D + hd;

  {  // zero every tile once: Q's pad columns D..DP then stay zero
    constexpr int n16 = smem_bytes<DP>() / 16;
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    for (int i = threadIdx.x; i < n16; i += kThreads)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int nb = (p.S + kKeys - 1) / kKeys;
  const int steps = SMQ ? 2 * nb : nb;
  // SMQ: steps 0..nb-1 read K blocks (pass 1), nb..2nb-1 K and V (pass 2);
  // else every step reads K and V
  auto load_step = [&](int i) {
    const int st = i % kStages;
    const bool with_v = !SMQ || i >= nb;
    const int s0 = (SMQ && i >= nb ? i - nb : i) * kKeys;
    load_rows_x<float, kKeys, LDK, DP, kThreads>(Ks + st * KT, kb, s0, p.S, p);
    if (with_v)
      load_rows_x<float, kKeys, LDV, DP, kThreads>(Vs + st * VT, vb, s0, p.S,
                                                   p);
  };
  load_rows_x<float, kRows, LDK, DP, kThreads>(Qs, qb, t0, p.T, p);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps) load_step(i);
    mmad::cp_commit();
  }

  float delta = 0.f, inv_delta = 0.f, zp = 0.f;
  if constexpr (SMQ) {
    delta = p.sm[0];
    zp = p.sm[1];
    inv_delta = 1.f / delta;
  }
  const float c = p.scale * mmad::kLog2e;
  // per lane: rows g = lane / 4 (r = 0) and g + 8 (r = 1) of the warp
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f}, linv[2] = {0.f, 0.f};
  uint32_t qh[kQReg ? KD : 1][4], ql[kQReg ? KD : 1][4];
  float o[KD][4];
#pragma unroll
  for (int j = 0; j < KD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    if (i + kStages - 1 < steps) load_step(i + kStages - 1);
    mmad::cp_commit();
    mmad::cp_wait<kStages - 1>();  // step i's group has landed
    __syncthreads();
    if constexpr (kQReg) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          load_a_tf32<LDK>(qh[kk], ql[kk], Qs, r0, kk * 8, lane);
      }
    }
    const int st = i % kStages;
    const bool pass2 = !SMQ || i >= nb;
    const int s0 = (SMQ && i >= nb ? i - nb : i) * kKeys;
    const float* K = Ks + st * KT;

    // s (16 x 64 per warp) = Q . K^T in 3xTF32
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (!kQReg) load_a_tf32<LDK>(ah, al, Qs, r0, kk * 8, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bk[4];
        load_bk_tf32<LDK>(bk, K, j * 8, kk * 8, lane);
        if constexpr (kQReg) {
          mma3(s[j], qh[kk], ql[kk], bk);
        } else {
          mma3(s[j], ah, al, bk);
        }
      }
    }
    // u = s * scale * log2 e in place of s, -inf past S (last block only)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= c;
    if (s0 + kKeys > p.S) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (s0 + j * 8 + quad * 2 + (e & 1) >= p.S)
            s[j][e] = mmad::kNegInf;
    }
    if (!pass2) {  // SMQ pass 1: this lane's online (max, sum-exp)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sum += mmad::ex2(s[j][2 * r] - mx) + mmad::ex2(s[j][2 * r + 1] - mx);
        l[r] = l[r] * mmad::ex2(m[r] - mx) + sum;
        m[r] = mx;
      }
    } else {
      if constexpr (SMQ) {
        if (i == nb) {  // pass 1 done: merge the quad's lanes
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mx = m[r];
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            float sum = l[r] * mmad::ex2(m[r] - mx);
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            linv[r] = 1.f / sum;
            m[r] = mx;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            s[j][e] = fq(mmad::ex2(s[j][e] - m[r]) * linv[r], delta,
                         inv_delta, zp, p.n_levels, p.symmetric,
                         p.always_zero);
          }
      } else {  // one pass: rescale o and l when the row max grows
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m[r];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float alpha = mmad::ex2(m[r] - mx);
          m[r] = mx;
          l[r] *= alpha;
#pragma unroll
          for (int jd = 0; jd < KD; ++jd) {
            o[jd][2 * r] *= alpha;
            o[jd][2 * r + 1] *= alpha;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = mmad::ex2(s[j][e] - m[e >> 1]);
            l[e >> 1] += s[j][e];
          }
      }
      // PV: the C-fragment of key tile kc, in pair order, is the
      // A-fragment of key step kc
      const float* V = Vs + st * VT;
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) {
        uint32_t ph[4], pl[4];
        split_tf32(s[kc][0], ph[0], pl[0]);
        split_tf32(s[kc][2], ph[1], pl[1]);
        split_tf32(s[kc][1], ph[2], pl[2]);
        split_tf32(s[kc][3], ph[3], pl[3]);
#pragma unroll
        for (int jd = 0; jd < KD; ++jd) {
          uint32_t bv[4];
          load_bv_tf32<LDV>(bv, V, jd * 8, kc * 8, lane);
          mma3(o[jd], ph, pl, bv);
        }
      }
    }
    __syncthreads();  // the next step's loads refill this stage
  }

  if constexpr (!SMQ) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      linv[r] = 1.f / sum;
    }
  }
  const size_t stride = (size_t)p.H * p.D;
  const bool pairs = (p.D & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + r0 + (lane >> 2) + 8 * r;
    if (t >= p.T) continue;
    float* orow = ob + (size_t)t * stride;
#pragma unroll
    for (int jd = 0; jd < KD; ++jd) {
      const int d = jd * 8 + quad * 2;
      float v0 = o[jd][2 * r], v1 = o[jd][2 * r + 1];
      if constexpr (!SMQ) {
        v0 *= linv[r];
        v1 *= linv[r];
      }
      if (pairs && d + 1 < p.D) {
        *reinterpret_cast<float2*>(orow + d) = make_float2(v0, v1);
      } else {
        if (d < p.D) orow[d] = v0;
        if (d + 1 < p.D) orow[d + 1] = v1;
      }
    }
  }
}

template <int DP>
int launch_dp(const Args& a, bool smq, int B, int H, cudaStream_t st) {
  constexpr int smem = smem_bytes<DP>();
  auto kern = smq ? &flash_tf32_kernel<DP, true>
                  : &flash_tf32_kernel<DP, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((a.T + kRows - 1) / kRows, B * H), kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// the D class: the smallest of 32, 40, 64, 80, 128 that holds D (the SD
// stream sites have D = 40 and 80, which need no padding at 8-deep steps)
int launch(const Args& a, bool smq, int B, int H, cudaStream_t st) {
  if (a.D <= 32) return launch_dp<32>(a, smq, B, H, st);
  if (a.D <= 40) return launch_dp<40>(a, smq, B, H, st);
  if (a.D <= 64) return launch_dp<64>(a, smq, B, H, st);
  if (a.D <= 80) return launch_dp<80>(a, smq, B, H, st);
  if (a.D <= 128) return launch_dp<128>(a, smq, B, H, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tf32

// -- flash_wide_kernel: 128 < D <= 512, bf16 and f32 -------------------------

namespace wide {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

template <typename T, int DP>
struct Cfg;
template <int DP>
struct Cfg<bf16, DP> {  // 4 row groups x 2 splits; ldmatrix rows padded 16 B
  static constexpr int BM = 64, BN = 64;
  static constexpr int LDQ = DP + 8, LDV = DP + 8, LDP = BN + 8;
  static constexpr int LDR = 0;  // no partial scores
  typedef bf16 PT;  // p in shared memory
};
template <int DP>
struct Cfg<float, DP> {  // 2 row groups x 4 splits; strides as tf32::
  static constexpr int BM = 32, BN = 32;
  static constexpr int LDQ = DP + 8, LDV = DP + 4, LDP = BN + 8;
  static constexpr int LDR = BN + 8;  // partial scores, one tile a split
  typedef float PT;
};

template <typename T, int DP>
__host__ __device__ constexpr int slot_elems() {
  return Cfg<T, DP>::BN *
         (Cfg<T, DP>::LDQ > Cfg<T, DP>::LDV ? Cfg<T, DP>::LDQ
                                            : Cfg<T, DP>::LDV);
}
template <typename T, int DP>
__host__ __device__ constexpr int smem_bytes() {
  using C = Cfg<T, DP>;
  return (int)sizeof(T) * (C::BM * C::LDQ + 2 * slot_elems<T, DP>()) +
         (int)sizeof(typename C::PT) * C::BM * C::LDP +
         2 * kWarps * 16 * 4 +      // the warps' row statistics
         kWarps * 16 * C::LDR * 4;  // f32: the splits' partial scores
}

template <typename T, int DP, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wide_kernel(const Args p) {
  using C = Cfg<T, DP>;
  typedef typename C::PT PT;
  constexpr int BM = C::BM, BN = C::BN;
  constexpr int LDQ = C::LDQ, LDV = C::LDV, LDP = C::LDP;
  constexpr int RG = BM / 16, SPLIT = kWarps / RG;
  constexpr int KW = BN / SPLIT, KT = KW / 8;  // a warp's keys, key tiles
  // PV: a warp takes 32 rows (two 16-row tiles, so that each V fragment
  // serves two mma) and one of PQ parts of D
  constexpr int PQ = kWarps / (BM / 32);
  constexpr int DW = DP / PQ, NT = DW / 8;  // its output columns, tiles
  constexpr int SLOT = slot_elems<T, DP>();
  constexpr bool kBf = std::is_same<T, bf16>::value;
  constexpr bool kAfter = EPI == mmad::kPostNorm;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);           // (BM, LDQ)
  T* Ring = Qs + BM * LDQ;                          // [2][SLOT]: K or V
  PT* Ps = reinterpret_cast<PT*>(Ring + 2 * SLOT);  // (BM, LDP)
  float* Mst = reinterpret_cast<float*>(Ps + BM * LDP);  // [SPLIT][BM]
  float* Lst = Mst + SPLIT * BM;                         // [SPLIT][BM]
  float* Sred = Lst + SPLIT * BM;  // f32: [SPLIT][BM][LDR] partial scores

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane & 3, g = lane >> 2;
  const int rg = warp % RG, sp = warp / RG;
  const int r0 = rg * 16;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int t0 = blockIdx.x * BM;
  const size_t hd = (size_t)h * p.D;
  const T* qb = static_cast<const T*>(p.q) + (size_t)b * p.T * p.H * p.D + hd;
  const T* kb = static_cast<const T*>(p.k) + (size_t)b * p.S * p.H * p.D + hd;
  const T* vb = static_cast<const T*>(p.v) + (size_t)b * p.S * p.H * p.D + hd;
  T* ob = static_cast<T*>(p.o) + (size_t)b * p.T * p.H * p.D + hd;

  {  // zero every tile once: Q's pad columns D..DP then stay zero
    constexpr int n16 = smem_bytes<T, DP>() / 16;
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    for (int i = threadIdx.x; i < n16; i += kThreads)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // steps 0..nb-1: K blocks (pass 1); then K, V of block j at nb + 2j and
  // nb + 2j + 1 (pass 2); step i uses ring slot i & 1
  const int nb = (p.S + BN - 1) / BN;
  const int steps = 3 * nb;
  auto load_step = [&](int i) {
    T* dst = Ring + (i & 1) * SLOT;
    const int j = i < nb ? i : (i - nb) >> 1;
    if (i < nb || ((i - nb) & 1) == 0)
      load_rows_x<T, BN, LDQ, DP, kThreads>(dst, kb, j * BN, p.S, p);
    else
      load_rows_x<T, BN, LDV, DP, kThreads>(dst, vb, j * BN, p.S, p);
  };
  load_rows_x<T, BM, LDQ, DP, kThreads>(Qs, qb, t0, p.T, p);
  load_step(0);
  mmad::cp_commit();

  float delta = 0.f, inv_delta = 0.f, zp = 0.f;
  if constexpr (EPI == mmad::kSmq) {
    delta = p.sm[0];
    zp = p.sm[1];
    inv_delta = 1.f / delta;
  }
  const float c = p.scale * mmad::kLog2e;
  // per lane: rows r0 + g (r = 0) and r0 + g + 8 (r = 1)
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f}, linv[2] = {0.f, 0.f};
  const int pr0 = (warp / PQ) * 32, c0 = (warp % PQ) * DW;  // PV's part
  float o[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) load_step(i + 1);
    mmad::cp_commit();
    mmad::cp_wait<1>();  // step i's group has landed
    __syncthreads();
    const T* tile = Ring + (i & 1) * SLOT;
    const bool pass2 = i >= nb;
    const int s0 = (pass2 ? (i - nb) >> 1 : i) * BN;
    if (!pass2 || ((i - nb) & 1) == 0) {
      // s (16 x KW) = Q[r0.., :] . K[sp * KW.., :]^T over the whole D
      // (raw: scale and shift are applied inside the exponent)
      const int n0 = sp * KW;
      float s[KT][4];
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if constexpr (kBf) {
#pragma unroll 4
        for (int kk = 0; kk < DP / 16; ++kk) {
          uint32_t qa[4];
          mmad::ldsm_x4(qa, mmad::smem_u32(Qs + (r0 + (lane & 15)) * LDQ +
                                           kk * 16 + (lane >> 4) * 8));
#pragma unroll
          for (int j = 0; j < KT; j += 2) {
            uint32_t kf[4];
            mmad::ldsm_x4(kf, mmad::smem_u32(
                                  tile + (n0 + j * 8 + (lane & 7) +
                                          ((lane >> 4) << 3)) * LDQ +
                                  kk * 16 + ((lane >> 3) & 1) * 8));
            mmad::mma16816(s[j], qa, kf[0], kf[1]);
            mmad::mma16816(s[j + 1], qa, kf[2], kf[3]);
          }
        }
      } else {
        // f32: each split takes the whole key block over its quarter of D
        // (four independent accumulators, a fresh one per 8-deep step),
        // then the quarters are added in split order through shared memory
        constexpr int KTF = BN / 8, KQ = DP / 8 / SPLIT;
        const float* Qf = reinterpret_cast<const float*>(Qs);
        const float* Kf = reinterpret_cast<const float*>(tile);
        float part[KTF][4];
#pragma unroll
        for (int j = 0; j < KTF; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll 4
        for (int kk = sp * KQ; kk < (sp + 1) * KQ; ++kk) {
          uint32_t ah[4], al[4];
          load_a_tf32<LDQ>(ah, al, Qf, r0, kk * 8, lane);
#pragma unroll
          for (int j = 0; j < KTF; ++j) {
            uint32_t bk[4];
            load_bk_tf32<LDQ>(bk, Kf, j * 8, kk * 8, lane);
            mma3_add(part[j], ah, al, bk);
          }
        }
        float* red = Sred + (sp * BM + r0 + g) * C::LDR + quad * 2;
#pragma unroll
        for (int j = 0; j < KTF; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(red + 8 * r * C::LDR + j * 8) =
                make_float2(part[j][2 * r], part[j][2 * r + 1]);
        __syncthreads();
#pragma unroll
        for (int q = 0; q < SPLIT; ++q)
#pragma unroll
          for (int j = 0; j < KT; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float2 x = *reinterpret_cast<const float2*>(
                  Sred + (q * BM + r0 + g + 8 * r) * C::LDR + n0 + j * 8 +
                  quad * 2);
              s[j][2 * r] += x.x;
              s[j][2 * r + 1] += x.y;
            }
      }
      // columns past S (TPU :101-103) exist in the last block only
      const bool ragged = s0 + BN > p.S;
      auto valid = [&](int j, int e) {
        return !ragged || s0 + n0 + j * 8 + quad * 2 + (e & 1) < p.S;
      };
      // e = exp(s * scale - m) = ex2(s * c - m') in one FFMA, m' a row max
      // of s * c; 0 past S
      auto expo = [&](int j, int e, float mr) {
        return valid(j, e) ? mmad::ex2(fmaf(s[j][e], c, -mr)) : 0.f;
      };
      if (!pass2) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m[r];
#pragma unroll
          for (int j = 0; j < KT; ++j)
#pragma unroll
            for (int x = 0; x < 2; ++x)
              if (valid(j, 2 * r + x)) mx = fmaxf(mx, s[j][2 * r + x] * c);
          if constexpr (!kAfter) {  // this lane's online (max, sum-exp)
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < KT; ++j)
              sum += expo(j, 2 * r, mx) + expo(j, 2 * r + 1, mx);
            l[r] = l[r] * mmad::ex2(m[r] - mx) + sum;
          }
          m[r] = mx;
        }
        if (i == nb - 1) {  // this warp's statistics, merged over the quad
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mx = m[r];
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            float sum = l[r] * mmad::ex2(m[r] - mx);
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            if (quad == 0) {
              Mst[sp * BM + r0 + g + 8 * r] = mx;
              Lst[sp * BM + r0 + g + 8 * r] = sum;
            }
          }
        }
      } else {
        if (i == nb) {  // the rows' statistics over every split
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r0 + g + 8 * r;
            float mx = kNegBig;
#pragma unroll
            for (int j = 0; j < SPLIT; ++j) mx = fmaxf(mx, Mst[j * BM + row]);
            if constexpr (!kAfter) {
              float sum = 0.f;
#pragma unroll
              for (int j = 0; j < SPLIT; ++j)
                sum += Lst[j * BM + row] * mmad::ex2(Mst[j * BM + row] - mx);
              linv[r] = 1.f / sum;
            }
            m[r] = mx;
          }
        }
        // e, then p, into the shared p tile; e = 0 past S
#pragma unroll
        for (int j = 0; j < KT; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float v[2];
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const float e = expo(j, 2 * r + x, m[r]);
              if constexpr (kAfter) {
                l[r] += e;
                v[x] = e;
              } else {
                v[x] = b23_epilogue<EPI, kBf>(e * linv[r], delta, inv_delta,
                                              zp, p);
              }
            }
            PT* dst = Ps + (r0 + g + 8 * r) * LDP + n0 + j * 8 + quad * 2;
            if constexpr (kBf) {
              *reinterpret_cast<uint32_t*>(dst) = mmad::pack_bf16(v[0], v[1]);
            } else {
              *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
            }
          }
        }
      }
    } else {
      // o[pr0.., c0..] += p[pr0.., :] . V[:, c0..]
      if constexpr (kBf) {
#pragma unroll
        for (int kc = 0; kc < BN / 16; ++kc) {
          uint32_t pa[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mmad::ldsm_x4(pa[mt], mmad::smem_u32(
                                      Ps + (pr0 + mt * 16 + (lane & 15)) *
                                               LDP +
                                      kc * 16 + (lane >> 4) * 8));
#pragma unroll
          for (int jd = 0; jd < NT; jd += 2) {
            uint32_t vf[4];
            mmad::ldsm_x4_t(vf, mmad::smem_u32(
                                    tile + (kc * 16 + (lane & 7) +
                                            ((lane >> 3) & 1) * 8) * LDV +
                                    c0 + jd * 8 + (lane >> 4) * 8));
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mmad::mma16816(o[mt][jd], pa[mt], vf[0], vf[1]);
              mmad::mma16816(o[mt][jd + 1], pa[mt], vf[2], vf[3]);
            }
          }
        }
      } else {
#pragma unroll
        for (int kc = 0; kc < BN / 8; ++kc) {
          uint32_t ph[2][4], pl[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            load_a_tf32<LDP>(ph[mt], pl[mt],
                             reinterpret_cast<const float*>(Ps),
                             pr0 + mt * 16, kc * 8, lane);
#pragma unroll
          for (int jd = 0; jd < NT; ++jd) {
            uint32_t bv[4];
            load_bv_tf32<LDV>(bv, reinterpret_cast<const float*>(tile),
                              c0 + jd * 8, kc * 8, lane);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma3(o[mt][jd], ph[mt], pl[mt], bv);
          }
        }
      }
    }
    __syncthreads();  // p and the ring slot are free again
  }

  if constexpr (kAfter) {  // l of each row, summed over the splits
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (quad == 0) Lst[sp * BM + r0 + g + 8 * r] = sum;
    }
    __syncthreads();
  }
  const size_t stride = (size_t)p.H * p.D;
  const bool pairs = (p.D & 1) == 0;
#pragma unroll
  for (int x = 0; x < 4; ++x) {  // rows pr0 + 8x + g
    const int mt = x >> 1, r = x & 1;
    const int row = pr0 + 8 * x + g;
    const int t = t0 + row;
    if (t >= p.T) continue;
    float inv = 1.f;
    if constexpr (kAfter) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SPLIT; ++j) sum += Lst[j * BM + row];
      inv = 1.f / sum;
    }
    T* orow = ob + (size_t)t * stride;
#pragma unroll
    for (int jd = 0; jd < NT; ++jd) {
      const int d = c0 + jd * 8 + quad * 2;
      const float v0 = o[mt][jd][2 * r] * inv, v1 = o[mt][jd][2 * r + 1] * inv;
      if (pairs && d + 1 < p.D) {
        if constexpr (kBf) {
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(orow + d) = make_float2(v0, v1);
        }
      } else {
        if constexpr (kBf) {
          if (d < p.D) orow[d] = __float2bfloat16(v0);
          if (d + 1 < p.D) orow[d + 1] = __float2bfloat16(v1);
        } else {
          if (d < p.D) orow[d] = v0;
          if (d + 1 < p.D) orow[d + 1] = v1;
        }
      }
    }
  }
}

template <typename T, int DP, int EPI>
int launch_cfg(const Args& a, int B, int H, cudaStream_t st) {
  constexpr int smem = smem_bytes<T, DP>();
  auto kern = flash_wide_kernel<T, DP, EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int BM = Cfg<T, DP>::BM;
  kern<<<dim3((a.T + BM - 1) / BM, B * H), kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int EPI>
int launch_d(const Args& a, int B, int H, cudaStream_t st) {
  if (a.D <= 256) return launch_cfg<T, 256, EPI>(a, B, H, st);
  if (a.D <= 512) return launch_cfg<T, 512, EPI>(a, B, H, st);
  return (int)cudaErrorInvalidValue;
}

// bf16: B2's and B3's three epilogues; f32: normalise after PV without sm_q
// (nothing is rounded before PV, so B2's and B3's functions agree to f32
// rounding), fq under it
int launch(const Args& a, bool bf, int epi, int B, int H, cudaStream_t st) {
  if (!bf) {
    return epi == mmad::kSmq ? launch_d<float, mmad::kSmq>(a, B, H, st)
                             : launch_d<float, mmad::kPostNorm>(a, B, H, st);
  }
  switch (epi) {
    case mmad::kPostNorm: return launch_d<bf16, mmad::kPostNorm>(a, B, H, st);
    case mmad::kCastRt: return launch_d<bf16, mmad::kCastRt>(a, B, H, st);
    case mmad::kSmq: return launch_d<bf16, mmad::kSmq>(a, B, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wide

}  // namespace

// q: (B, T, H, D), k, v: (B, S, H, D), o: (B, T, H, D), all contiguous,
// bf16 (is_bf16 = 1) or f32, D <= 512. sm: device pointer to [delta,
// zero_point] when sm_on, else ignored. norm_before = 1 selects B3's
// function (the normaliser before PV even without sm_q), 0 B2's. bf16 with
// D <= 128 runs flash_mma_kernel, f32 with D <= 128 flash_tf32_kernel, the
// rest flash_wide_kernel. Launches on `stream` and returns the CUDA error of
// the launch (0 on success).
extern "C" int qdt_flash_attention(const void* q, const void* k,
                                   const void* v, void* o, const float* sm,
                                   int B, int T, int S, int H, int D,
                                   float scale, int is_bf16, int sm_on,
                                   int n_levels, int symmetric,
                                   int always_zero, int norm_before,
                                   void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || D <= 0 || D > 512 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int epi = sm_on ? mmad::kSmq
                        : (norm_before ? mmad::kCastRt : mmad::kPostNorm);
  if (is_bf16 && D <= 128) {
    mmad::Params mp = mmad::make_params(q, k, v, o, T, S, H, D, scale);
    mp.sm = sm;
    mp.n_levels = n_levels;
    mp.symmetric = symmetric;
    mp.always_zero = always_zero;
    return mmad::launch_epi(mp, epi, B, H, st);
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.sm = sm;
  a.T = T;
  a.S = S;
  a.H = H;
  a.D = D;
  a.scale = scale;
  a.n_levels = n_levels;
  a.symmetric = symmetric;
  a.always_zero = always_zero;
  // 16-byte chunks: D a multiple of the chunk and every row start aligned
  const int chunk = is_bf16 ? 8 : 4;
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  a.vec = D % chunk == 0 && addr % 16 == 0;
  if (!is_bf16 && D <= 128) return tf32::launch(a, sm_on, B, H, st);
  return wide::launch(a, is_bf16, epi, B, H, st);
}

// P: q (B, T, H, D), k, v (B, S, H, D), o (B, T, H, D), bf16, contiguous,
// D <= 48; mode 0-8 is P's mode in P's order (mmad::Epi, delta = 1/255).
// Launches flash_mma_kernel on `stream` and returns the CUDA error of the
// launch (0 on success).
extern "C" int qdt_flash_epilogue(const void* q, const void* k,
                                  const void* v, void* o, int B, int T,
                                  int S, int H, int D, float scale, int mode,
                                  void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || D <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const mmad::Params mp = mmad::make_params(q, k, v, o, T, S, H, D, scale);
  return mmad::launch_p(mp, mode, B, H, static_cast<cudaStream_t>(stream));
}
