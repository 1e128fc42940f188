// Integer matrix products of the int8 and stream deployment engines:
// kernels B4, B5 and B6 of the port.
//
// Replaces, by function:
//   B4  qdiffusion_tpu/ops/pallas/int8_matmul.py::int8_matmul_dequant
//       (pallas_call :88, kernel body `_kernel` :36-54; wrapper
//       `int8_dense_pallas` :124);
//   B5  qdiffusion_tpu/ops/pallas/int8_matmul.py::int8_stream_matmul
//       (pallas_call :216, `_stream_kernel` :157-183; wrapper
//       `int8_dense_stream` :249);
//   B6  qdiffusion_tpu/ops/pallas/int4_matmul.py::int4_stream_matmul
//       (pallas_call :129, `_kernel` :69-96; wrapper `int4_dense_stream`
//       :170).
// The wrappers are qdiffusion_torch/ops/int8_conv.py (B4; also reached by
// ops/int8_matmul.py::int8_matmul_dequant), ops/int8_matmul.py (B5) and
// ops/int4_matmul.py (B6).
//
// The function, per output element (m, n), with S(x)[m] the row sum of x:
//   B4  per input-channel segment s of a conv site (one, or two at the
//       split 1x1 shortcut convs), on the site's NHWC activation x:
//         x_c = clamp(rint(x / delta_s) + zp_s) - centre_s   (int8;
//               a_pad_s outside the image)
//         acc = sum_(i,j,c) x_c[b, ho*sh+i-pt, wo*sw+j-pl, c] * w_c[n]
//               (int8 x int8, exact int32), S the same window's sum
//         y_s = A_s[n]*float(acc) + Bc_s[n]*S + C_s[n]
//       y = (y_0 + y_1) + bias[n], cast once to f32 or bf16; a dense
//       layer is the case kh = kw = H = W = 1
//   B5  acc = sum_k bf16(x)[m,k] * w_c[k,n]   (int8 w, exact in bf16)
//       y   = scale[n]*acc + shift[n]*S(bf16(x))[m] + const[n]
//   B6  as B5 with w the nibbles of a (K/2, N) uint8 pack: the low nibble
//       of packed row k is row k of w, the high nibble row k + K/2
//       (int4_matmul.py:29-33).
// B5/B6 take f32 or bf16 x and round it to bf16 (nearest even) as they
// build its MMA fragments (the TPU wrappers' x.astype(bfloat16),
// int8_matmul.py:243, int4_matmul.py:160); products are bf16 MMAs with f32
// sums; y is f32 or bf16. The epilogues use round-to-nearest multiplies
// and adds in the plain versions' order ((a*b) + (c*d)) + e, with no FMA
// contraction, so a B4 output equals its plain version bit for bit.
//
// What bounds it on an H100: B4 at the CIFAR W4A8 sites (M = 64*H*W up to
// 65,536 output pixels, K up to 4,608, N up to 512) reads the bf16
// activation once, 33 MB of weights and writes the bf16 output once per
// step: about 0.44 ms of device-memory time against 0.39 ms of int8
// tensor work, so bytes, closely followed by the int8 tensor rate. The
// TPU design multiplied patches gathered in device memory (9x the
// activation at 3x3); this one pads and gathers in the load path, and
// adds one int8 copy of the activation (written once, read from L2 by
// the taps) to what crosses device memory. B5/B6 at the SD
// stream shapes of batch 2 (M = 2 ... 8,192 rows): the weight bytes where
// M is small (time-embedding linears at M = 2, context projections at
// 154, the 8x8 convs at 128) and the x bytes and bf16 tensor-core rate
// at M >= 2,048.
//
// B4 (Hopper design, see the note at the B4 section): a quantize pass
// that writes the activation once as int8 NHWC, then an implicit GEMM
// over it with the pad value and the tap gather in its cp.async load
// path, mma.sync m16n8k32 int8 with int32 sums, both segments' epilogues
// fused, K split by a host plan (ops/int8_conv.py::conv_plan) where the
// output tiles alone leave SMs idle.
//
// B5/B6 (Hopper design, see the note at stream_mma_kernel): a host-side
// plan (ops/int8_matmul.py::stream_plan) picks a 16 x 128 or 32 x 128
// tile by M and splits K until the grid fills about two blocks per SM;
// a 3-4 stage cp.async ring feeds mma.sync m16n8k16 with the weights
// widened in registers; a second small kernel adds the K splits in a
// fixed order. Ragged M, N and K edges are masked while staging (zeros)
// and at the store; no operand is padded in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ float affine(float acc, float s, float b,
                                        float sum, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(acc, s), __fmul_rn(sum, b)), c);
}

// ------------------------------------------------------------ B5 / B6 ----
//
// One template, stream_mma_kernel<BM, BN, WM, STAGES, MINB, XT, NH>, with
// NH = 1 for B5 (int8 w) and NH = 2 for B6 (nibble pack). Each block
// computes a BM x BN output tile over one split [kbeg, kend) of the weight
// rows: for B6 packed rows [k0, k1) cover x columns [k0, k1) (low
// nibbles) and [K/2 + k0, K/2 + k1) (high nibbles). A stage holds 64 x
// columns (64 weight rows for B5, 32 packed rows for B6), copied by
// cp.async into a ring of STAGES buffers: x in its own dtype, w as its
// bytes. Each thread computes the sources of its 16-byte chunks once;
// a stage then costs it one pointer step and one copy per chunk.
//
// Fragments come straight from the ring. x: for f32, paired 8-byte
// ld.shared rounded by cvt.rn.bf16x2.f32 (nearest even); for bf16,
// ldmatrix. w: lane (g, t) of a warp reads one 32-bit word (4 columns)
// from each of the rows 2t, 2t+1, 2t+8, 2t+9 of a 16-row step and widens
// it in registers, so that column index g of n-tile j is the warp's
// column 4g + j. int8: byte ^ 0x80 under the f32 exponent of 2^23, minus
// 2^23 + 128, is the value exactly, then two values per cvt to bf16x2.
// Nibbles: 0x4300 | v is the bf16 of 128 + v, minus 128 in bf16x2: exact.
// The accumulator fragments then hold, per lane, 8 consecutive columns
// 8t .. 8t+7 of rows g and g+8: the epilogue stores them as vectors.
//
// S(bf16(x)) comes from one more mma per A fragment, against a B of ones.
// Every warp column issues it and the first column's sums are kept:
// sharing a stage's four 16-column steps out over the four columns (each
// product once) branches inside the unrolled loop and measured slower on
// an H100 (bench_stream_matmul --variants, s_shared_out). With one
// split the block applies the affine epilogue itself; with several, each
// writes its raw sums (and, for the first column of blocks, its S
// partials) to an f32 workspace and stream_reduce_kernel adds the splits
// in order 0, 1, ... and applies the epilogue once: no atomics, so two
// launches give the same bits.

constexpr int SWN = 32;     // warp tile columns (4 n-tiles of 8)
constexpr int XSTAGE = 64;  // x columns per stage
constexpr int XPAD = 8;     // x row pad, elements (conflict-free fragments)
constexpr uint32_t kOnes = 0x3F803F80u;  // bf16x2 {1, 1}

struct SParams {
  const void* x;       // (M, K) f32 or bf16
  const uint8_t* w;    // (kw, N) int8 (B5) or nibble pack (B6)
  const float* scale;  // (N,)
  const float* shift;  // (N,)
  const float* cnst;   // (N,)
  void* y;             // (M, N) f32, or bf16 when y_bf16
  float* ws;           // splits > 1: [splits][M][N] sums, then [splits][M] S
  int M, N, K, kw;     // kw: rows of w (K for B5, K/2 for B6)
  int kps;             // weight rows per split, a multiple of the stage's
  int vec;             // 16-byte copies allowed (strides and pointers)
  int y_bf16;
};

template <int BM, int BN, int WM, int STAGES, int MINB, typename XT, int NH>
struct Cfg {
  static constexpr int KW = XSTAGE / NH;  // weight rows per stage
  static constexpr int XLD = KW + XPAD;   // x row stride, elements
  static constexpr int WLD = BN + 16;     // w row stride, bytes
  static constexpr int WARPS = (BM / WM) * (BN / SWN);
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MI = WM / 16;
  static constexpr int X_BYTES = NH * BM * XLD * (int)sizeof(XT);
  static constexpr int STAGE_BYTES = X_BYTES + KW * WLD;
  static constexpr int SMEM = STAGES * STAGE_BYTES + BM * (int)sizeof(float);
  // 16-byte chunks: per x row of a stage, per w row; per thread per stage
  static constexpr int EPC = 16 / (int)sizeof(XT);
  static constexpr int XCH = KW / EPC, WCH = BN / 16;
  static constexpr int NXC = NH * BM * XCH / THREADS;
  static constexpr int NWC = KW * WCH / THREADS;
  static_assert(X_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0, "alignment");
  static_assert(NXC * THREADS == NH * BM * XCH && THREADS % XCH == 0 &&
                    NWC * THREADS == KW * WCH && THREADS % WCH == 0,
                "every thread copies whole chunks at fixed columns");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled (nothing read) when !ok
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A stage of operands whose rows or pointers do not allow 16-byte copies
// (ragged K or N): element by element, zero past M, kend and N
template <class C, typename XT, int NH, int BM, int BN>
__device__ void load_stage_ragged(const SParams& p, uint8_t* buf, int m0,
                                  int n0, int kr0, int kend, int tid) {
  const XT* X = static_cast<const XT*>(p.x);
  XT* sx = reinterpret_cast<XT*>(buf);
  for (int i = tid; i < NH * BM * C::KW; i += C::THREADS) {
    const int h = i / (BM * C::KW), r = (i / C::KW) % BM, c = i % C::KW;
    const int m = m0 + r, col = kr0 + c;
    sx[(h * BM + r) * C::XLD + c] =
        m < p.M && col < kend ? X[(size_t)m * p.K + (size_t)h * p.kw + col]
                              : XT(0.f);
  }
  uint8_t* sw = buf + C::X_BYTES;
  for (int i = tid; i < C::KW * BN; i += C::THREADS) {
    const int r = i / BN, c = i % BN, k = kr0 + r, n = n0 + c;
    sw[r * C::WLD + c] =
        k < kend && n < p.N ? p.w[(size_t)k * p.N + n] : (uint8_t)0;
  }
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // cvt.rn: nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 x 16, rows r0.., columns c0..) of an x tile in shared
// memory, rounded to bf16
__device__ __forceinline__ void load_a(uint32_t* a, const float* s, int ld,
                                       int r0, int c0, int lane) {
  const int g = lane / 4, t = lane % 4;
  const float* p0 = s + (r0 + g) * ld + c0 + 2 * t;
  const float* p1 = p0 + 8 * ld;
  const float2 v0 = *reinterpret_cast<const float2*>(p0);
  const float2 v1 = *reinterpret_cast<const float2*>(p1);
  const float2 v2 = *reinterpret_cast<const float2*>(p0 + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(p1 + 8);
  a[0] = pack_bf16(v0.x, v0.y);
  a[1] = pack_bf16(v1.x, v1.y);
  a[2] = pack_bf16(v2.x, v2.y);
  a[3] = pack_bf16(v3.x, v3.y);
}
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* s, int ld,
                                       int r0, int c0, int lane) {
  const bf16* p = s + (r0 + lane % 16) * ld + c0 + (lane / 16) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

// int8: bf16x2 {w0 byte j, w1 byte j} (rows k, k+1 of column j), exactly
__device__ __forceinline__ uint32_t widen_i8(uint32_t w0x, uint32_t w1x,
                                             int j) {
  // w0x, w1x: the words with each byte ^ 0x80 (v + 128, unsigned)
  const uint32_t sel = 0x7540u | (uint32_t)j;  // 0x4B0000uu: 2^23 + uu
  const float f0 = __uint_as_float(__byte_perm(w0x, 0x4B000000u, sel));
  const float f1 = __uint_as_float(__byte_perm(w1x, 0x4B000000u, sel));
  return pack_bf16(f0 - 8388736.f, f1 - 8388736.f);  // exact integers
}

// nibbles: bf16x2 {w0 low nibble, w1 low nibble} of column j (the words
// shifted right by 4 give the high nibbles), exactly
__device__ __forceinline__ uint32_t widen_nib(uint32_t w0, uint32_t w1,
                                              int j) {
  const uint32_t pr = __byte_perm(w0, w1, (uint32_t)(j | (4 + j) << 8));
  const uint32_t v = (pr & 0x000F000Fu) | 0x43004300u;  // 128 + v
  __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v);
  b = __hsub2(b, __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<uint32_t*>(&b);
}

template <int BM, int BN, int WM, int STAGES, int MINB, typename XT, int NH>
__global__ void __launch_bounds__(
    Cfg<BM, BN, WM, STAGES, MINB, XT, NH>::THREADS, MINB)
    stream_mma_kernel(const SParams p) {
  using C = Cfg<BM, BN, WM, STAGES, MINB, XT, NH>;
  constexpr int MI = C::MI;
  extern __shared__ __align__(128) uint8_t smem[];
  float* sS = reinterpret_cast<float*>(smem + STAGES * C::STAGE_BYTES);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / (BN / SWN), wn = warp % (BN / SWN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int split = blockIdx.z;
  const int kbeg = split * p.kps, kend = min(kbeg + p.kps, p.kw);
  const int nst = (kend - kbeg + C::KW - 1) / C::KW;

  // this thread's chunks of a stage: x chunk j is smem row tid / XCH + j *
  // XROWS (row h * BM + r: half h, tile row r) at column xc; w chunk j is
  // w row wr + j * WROWS at byte column wc
  const XT* X = static_cast<const XT*>(p.x);
  constexpr int XROWS = C::THREADS / C::XCH, WROWS = C::THREADS / C::WCH;
  const int xc = (tid % C::XCH) * C::EPC;
  const XT* xg[C::NXC];
  bool xok[C::NXC];
#pragma unroll
  for (int j = 0; j < C::NXC; ++j) {
    const int ri = tid / C::XCH + j * XROWS, m = m0 + ri % BM;
    xok[j] = m < p.M;
    xg[j] = X + (size_t)(xok[j] ? m : 0) * p.K + (size_t)(ri / BM) * p.kw +
            kbeg + xc;
  }
  const int wc = (tid % C::WCH) * 16, wr = tid / C::WCH;
  const bool nok = n0 + wc < p.N;
  const uint8_t* wg = p.w + (size_t)(kbeg + wr) * p.N + (nok ? n0 + wc : 0);
  const uint32_t s_base = smem_addr(smem);
  const uint32_t xs = s_base + ((tid / C::XCH) * C::XLD + xc) * sizeof(XT);
  const uint32_t wsm = s_base + C::X_BYTES + wr * C::WLD + wc;

  auto load = [&](int s) {  // stage s of this split into its ring slot
    const int slot = s % STAGES, k0 = s * C::KW;
    if (!p.vec) {
      load_stage_ragged<C, XT, NH, BM, BN>(
          p, smem + slot * C::STAGE_BYTES, m0, n0, kbeg + k0, kend, tid);
      return;
    }
    const uint32_t off = slot * C::STAGE_BYTES;
    const bool kok = kbeg + k0 + xc < kend;
#pragma unroll
    for (int j = 0; j < C::NXC; ++j) {
      const bool ok = xok[j] && kok;
      cp16(xs + off + j * XROWS * C::XLD * sizeof(XT),
           ok ? xg[j] + k0 : X, ok);
    }
#pragma unroll
    for (int j = 0; j < C::NWC; ++j) {
      const int r = k0 + wr + j * WROWS;
      const bool ok = nok && kbeg + r < kend;
      cp16(wsm + off + j * WROWS * C::WLD,
           ok ? wg + (size_t)(k0 + j * WROWS) * p.N : p.w, ok);
    }
  };

  float acc[MI][4][4], sacc[MI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sacc[i][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j][e] = 0.f;
    }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s);
    cp_commit();
  }
  for (int it = 0; it < nst; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage `it` landed; every warp is done with it - 1
    if (it + STAGES - 1 < nst) load(it + STAGES - 1);
    cp_commit();
    const uint8_t* buf = smem + (it % STAGES) * C::STAGE_BYTES;
    const XT* sx = reinterpret_cast<const XT*>(buf);
    const uint8_t* sw = buf + C::X_BYTES + wn * SWN + 4 * g;
#pragma unroll
    for (int kk = 0; kk < C::KW; kk += 16) {
      const uint32_t r0 = *reinterpret_cast<const uint32_t*>(
          sw + (kk + 2 * t) * C::WLD);
      const uint32_t r1 = *reinterpret_cast<const uint32_t*>(
          sw + (kk + 2 * t + 1) * C::WLD);
      const uint32_t r8 = *reinterpret_cast<const uint32_t*>(
          sw + (kk + 2 * t + 8) * C::WLD);
      const uint32_t r9 = *reinterpret_cast<const uint32_t*>(
          sw + (kk + 2 * t + 9) * C::WLD);
      uint32_t b[NH][4][2];
      if constexpr (NH == 1) {
        const uint32_t f = 0x80808080u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[0][j][0] = widen_i8(r0 ^ f, r1 ^ f, j);
          b[0][j][1] = widen_i8(r8 ^ f, r9 ^ f, j);
        }
      } else {
        const uint32_t w[2][4] = {{r0, r1, r8, r9},
                                  {r0 >> 4, r1 >> 4, r8 >> 4, r9 >> 4}};
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            b[h][j][0] = widen_nib(w[h][0], w[h][1], j);
            b[h][j][1] = widen_nib(w[h][2], w[h][3], j);
          }
      }
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          uint32_t a[4];
          load_a(a, sx + h * BM * C::XLD, C::XLD, wm * WM + i * 16, kk,
                 lane);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[i][j], a, b[h][j][0], b[h][j][1]);
          mma_bf16(sacc[i], a, kOnes, kOnes);
        }
    }
  }
  cp_wait<0>();

  // S: every column of sacc holds the row sums; lane t = 0 writes them
  if (wn == 0 && t == 0) {
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      sS[wm * WM + i * 16 + g] = sacc[i][0];
      sS[wm * WM + i * 16 + g + 8] = sacc[i][2];
    }
  }
  __syncthreads();

  const bool partial = gridDim.z > 1;
  if (partial && blockIdx.x == 0) {
    for (int r = tid; r < BM; r += C::THREADS)
      if (m0 + r < p.M)
        p.ws[(size_t)gridDim.z * p.M * p.N + (size_t)split * p.M + m0 + r] =
            sS[r];
  }
  const int nb = n0 + wn * SWN + 8 * t;  // this lane's 8 columns
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int rl = wm * WM + i * 16 + g + 8 * q, m = m0 + rl;
      if (m >= p.M) continue;
      float v[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[i][e][2 * q];
        v[4 + e] = acc[i][e][2 * q + 1];
      }
      const size_t row = (size_t)m * p.N;
      if (partial) {
        float* dst = p.ws + (size_t)split * p.M * p.N + row;
        if (p.N % 4 == 0 && nb + 8 <= p.N) {
          *reinterpret_cast<float4*>(dst + nb) =
              make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(dst + nb + 4) =
              make_float4(v[4], v[5], v[6], v[7]);
        } else {
          for (int e = 0; e < 8; ++e)
            if (nb + e < p.N) dst[nb + e] = v[e];
        }
        continue;
      }
      const float srow = sS[rl];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int n = min(nb + e, p.N - 1);
        v[e] = affine(v[e], p.scale[n], p.shift[n], srow, p.cnst[n]);
      }
      if (p.y_bf16) {
        bf16* dst = static_cast<bf16*>(p.y) + row;
        if (p.N % 8 == 0 && nb + 8 <= p.N) {
          *reinterpret_cast<uint4*>(dst + nb) =
              make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                         pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
        } else {
          for (int e = 0; e < 8; ++e)
            if (nb + e < p.N) dst[nb + e] = __float2bfloat16_rn(v[e]);
        }
      } else {
        float* dst = static_cast<float*>(p.y) + row;
        if (p.N % 4 == 0 && nb + 8 <= p.N) {
          *reinterpret_cast<float4*>(dst + nb) =
              make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(dst + nb + 4) =
              make_float4(v[4], v[5], v[6], v[7]);
        } else {
          for (int e = 0; e < 8; ++e)
            if (nb + e < p.N) dst[nb + e] = v[e];
        }
      }
    }
}

// Split-K reduction: y = affine(sum_s ws[s], ..., sum_s S_s), the splits
// added in order 0, 1, ...; one thread per 4 columns of a row (N % 4 == 0)
// or per output
__global__ void __launch_bounds__(256)
    stream_reduce_kernel(const SParams p, int splits) {
  const int per = p.N % 4 == 0 ? 4 : 1;
  const int cols = p.N / per;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)p.M * cols) return;
  const int m = (int)(idx / cols), n = (int)(idx % cols) * per;
  const size_t mn = (size_t)p.M * p.N;
  const float* sp = p.ws + (size_t)splits * mn + m;
  const float* src = p.ws + (size_t)m * p.N + n;
  float srow = 0.f;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (per == 4) {
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {  // loads issued ahead, adds in order
      const float4 a = *reinterpret_cast<const float4*>(src + s * mn);
      v.x += a.x, v.y += a.y, v.z += a.z, v.w += a.w;
      srow += sp[(size_t)s * p.M];
    }
  } else {
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      v.x += src[s * mn];
      srow += sp[(size_t)s * p.M];
    }
  }
  const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e >= per) break;
    const int c = n + e;
    const float out = affine(vv[e], p.scale[c], p.shift[c], srow, p.cnst[c]);
    const size_t i = (size_t)m * p.N + c;
    if (p.y_bf16)
      static_cast<bf16*>(p.y)[i] = __float2bfloat16_rn(out);
    else
      static_cast<float*>(p.y)[i] = out;
  }
}

// Launch one configuration (raising its dynamic shared memory limit
// once per device first); returns the first CUDA error
template <int BM, int BN, int WM, int STAGES, int MINB, typename XT, int NH>
int launch_stream_cfg(const SParams& p, int splits, cudaStream_t st) {
  using C = Cfg<BM, BN, WM, STAGES, MINB, XT, NH>;
  auto kern = stream_mma_kernel<BM, BN, WM, STAGES, MINB, XT, NH>;
  static unsigned raised = 0;  // bit d: done on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(raised >> dev & 1u)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    raised |= 1u << dev;
  }
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splits);
  kern<<<grid, C::THREADS, C::SMEM, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int per = p.N % 4 == 0 ? 4 : 1;
  const size_t threads = (size_t)p.M * (p.N / per);
  stream_reduce_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      p, splits);
  return (int)cudaGetLastError();
}

// The plan's tiles (ops/int8_matmul.py::STREAM_TILE_ROWS): bm x 128, each
// with 4 warps of bm x 32, a ring of 4 stages and 4 or 3 blocks per SM
template <typename XT, int NH>
int launch_stream_tile(const SParams& p, int bm, int splits,
                       cudaStream_t st) {
  if (bm == 16)
    return launch_stream_cfg<16, 128, 16, 4, 4, XT, NH>(p, splits, st);
  if (bm == 32)
    return launch_stream_cfg<32, 128, 32, 4, 3, XT, NH>(p, splits, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- B4 ----
//
// Two kernels per site. int8_quantize_kernel<XT> reads the site's f32 /
// bf16 activation once (NHWC memory, row strides given) and writes it
// quantized, once, as contiguous int8 NHWC: per value the segment's
// quantize_act (IEEE division by delta, round half to even, + zp, clamp,
// - centre). No padding and no gather happen there.
//
// int8_conv_kernel<NSEG, MINB> is then one conv site (or dense layer)
// as an implicit GEMM, M = B*Ho*Wo output pixels by N output channels,
// over the K = kh*kw*C taps x channels of each of NSEG input channel
// segments (2 at the split 1x1 shortcut convs). The K loop walks stages
// of BK = 64 values of one segment, in tap-major order (k = (i*kw + j)*C
// + c), the order of the segment's weight copy w_t (N, kh, kw, C).
// A tile (BM x BK int8): each thread owns one 16-value chunk column of
// NA rows. Once per block it computes each row's window corner (b,
// ho*sh - pt, wo*sw - pl) as an offset and a bit per tap whose pixel lies
// inside the image; then it walks its (tap, channel) position stage by
// stage without a division. A chunk of a segment with C % 16 == 0 lies in
// one tap: 16 channels by cp.async, or the segment's pad value where the
// tap's pixel is outside the image. Other segments (C = 3) copy value by
// value. B tile (BN x BK of w_t): cp.async, zero-filled past N and K. A
// ring of STAGES such stages keeps the copies STAGES - 1 stages ahead of
// the products; ldmatrix feeds mma.sync m16n8k32 s8 x s8 -> s32, 8 warps
// in 2 x 4 of 64 x 32. S, the row sums of the A operand (pad values
// included), comes from the landed tile in shared memory: two threads a
// row, by dp4a.
//
// Epilogue: y_s = (A_s*float(acc_s) + Bc_s*S_s) + C_s per segment in
// round-to-nearest f32 (no FMA), y = (y_0 + y_1) + bias, one cast to the
// output type. With one K split (gridDim.z == 1) a block does every
// segment: y_0 stays in f32 registers while segment 1 accumulates. With
// several (the launch plan's choice where the output tiles leave SMs
// idle), each block does `sps` stages of one segment and writes int32
// partials (and S partials, from the first column of blocks) to a
// workspace; int8_conv_reduce_kernel adds them, exact in any order, and
// applies the same epilogue. Two launches give the same bits.
//
// An int8 x (int8_matmul_dequant's (M, K) rows as M pixels of K
// channels) skips the quantize kernel.

namespace b4 {
constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256, STAGES = 4;
constexpr int LDS = BK + 16;  // shared row stride, bytes: ldmatrix rows
                              // 80 (or 144) bytes apart hit distinct banks
constexpr int A_BYTES = BM * LDS, STAGE_BYTES = A_BYTES + BN * LDS;
constexpr int SMEM = STAGES * STAGE_BYTES;
constexpr int WM = 64, WN = 32, MI = WM / 16, NI = WN / 8;
// copies: a thread owns 16-byte chunk column tid % CPR of rows
// tid / CPR + RPP * j, NA of the A tile and NB of the B tile
constexpr int CPR = BK / 16, RPP = THREADS / CPR;
constexpr int NA = BM / RPP, NB = BN / RPP;

struct Seg {
  const int8_t* x;  // element (0, 0, 0, first channel of the segment)
  const int8_t* w;  // (N, K) int8, K in tap-major order
  const float *A, *Bc, *Cc;  // (N,) f32 epilogue constants
  int a_pad;                 // int8 value of f32 zero
  int C, K, kst;             // channels, kh*kw*C, stages of BK
  int xvec, wvec;            // 16-byte copies allowed for x / for w
};

struct Params {
  Seg seg[2];
  int nseg;
  const float* bias;  // (N,) f32 or null
  void* y;            // (M, N) f32, or bf16 when y_bf16
  int* ws;            // splits > 1: [splits][M][N] acc, then [splits][M] S
  int M, N, H, W, Ho, Wo, kh, kw, sh, sw, pt, pl;
  long long sb, srow, spix;  // int8 x strides, elements: image, row, pixel
  int y_bf16, splits, sps, pieces0;
};

struct QParams {  // int8_quantize_kernel
  const void* x;  // f32 / bf16, channel 0 of segment 0
  int8_t* xq;     // (B*H*W, C0 + C1) int8, contiguous
  long long sb, srow, spix;
  // each segment's delta and zero point (on the device), clamp range and
  // centre: scalars, not arrays, so that a runtime segment index selects
  // between two parameters instead of copying them to local memory
  const float *d0, *z0, *d1, *z1;
  float lo0, hi0, ctr0, lo1, hi1, ctr1;
  int HW, W, C0, Ct, vec;
  int total;  // values (vec: 8-value chunks) to quantize, below 2^31
};
}  // namespace b4

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// quantize_act of one value: the recentred int8 value, as an int
__device__ __forceinline__ int quant1(float v, float d, float zp, float lo,
                                      float hi, float ctr) {
  float r = __fadd_rn(rintf(__fdiv_rn(v, d)), zp);
  r = fminf(fmaxf(r, lo), hi);
  return __float2int_rz(__fsub_rn(r, ctr));  // an integer: exact
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | (uint32_t)(b & 0xff) << 8 |
         (uint32_t)(c & 0xff) << 16 | (uint32_t)d << 24;
}

__device__ __forceinline__ int sum16(const uint4 q) {
  const int ones = 0x01010101;
  return __dp4a((int)q.x, ones, __dp4a((int)q.y, ones,
                __dp4a((int)q.z, ones, __dp4a((int)q.w, ones, 0))));
}

template <typename XT>
__device__ __forceinline__ float to_f32(XT v) {
  if constexpr (sizeof(XT) == 2)
    return __bfloat162float(v);
  else
    return v;
}

template <typename XT>
__global__ void __launch_bounds__(256)
    int8_quantize_kernel(const b4::QParams q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q.total) return;
  const XT* X = static_cast<const XT*>(q.x);
  const int per = q.vec ? q.Ct / 8 : q.Ct;
  const int p = i / per, c = (i - p * per) * (q.vec ? 8 : 1);
  const int b = p / q.HW, r = p - b * q.HW, h = r / q.W;
  const XT* src = X + b * q.sb + h * q.srow + (r - h * q.W) * q.spix + c;
  const bool s1 = c >= q.C0;
  const float d = *(s1 ? q.d1 : q.d0), zp = *(s1 ? q.z1 : q.z0);
  const float lo = s1 ? q.lo1 : q.lo0, hi = s1 ? q.hi1 : q.hi0;
  const float ctr = s1 ? q.ctr1 : q.ctr0;
  if (!q.vec) {  // one value
    q.xq[i] = (int8_t)quant1(to_f32(*src), d, zp, lo, hi, ctr);
    return;
  }
  float f[8];  // 8 channels of one segment: 16 or 32 bytes in, 8 out
  if constexpr (sizeof(XT) == 2) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[2 * e] = __uint_as_float(w[e] << 16);  // bf16: exact
      f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  } else {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 a2 = reinterpret_cast<const float4*>(src)[1];
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = a2.x, f[5] = a2.y, f[6] = a2.z, f[7] = a2.w;
  }
  int v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = quant1(f[e], d, zp, lo, hi, ctr);
  *reinterpret_cast<uint2*>(q.xq + (size_t)p * q.Ct + c) =
      make_uint2(pack4(v[0], v[1], v[2], v[3]), pack4(v[4], v[5], v[6], v[7]));
}

// y[m, n] and y[m, n + 1] (when n + 1 < N) of an (M, N) f32 / bf16 output
__device__ __forceinline__ void store_pair(void* y, int y_bf16, int N,
                                           int m, int n, float v0,
                                           float v1) {
  const size_t i = (size_t)m * N + n;
  const bool two = n + 1 < N;
  if (y_bf16) {
    bf16* yb = static_cast<bf16*>(y);
    if (two && N % 2 == 0) {
      *reinterpret_cast<uint32_t*>(yb + i) = pack_bf16(v0, v1);
    } else {
      yb[i] = __float2bfloat16_rn(v0);
      if (two) yb[i + 1] = __float2bfloat16_rn(v1);
    }
  } else {
    float* yf = static_cast<float*>(y);
    if (two && N % 2 == 0) {
      *reinterpret_cast<float2*>(yf + i) = make_float2(v0, v1);
    } else {
      yf[i] = v0;
      if (two) yf[i + 1] = v1;
    }
  }
}

template <int NSEG, int MINB>
__global__ void __launch_bounds__(b4::THREADS, MINB)
    int8_conv_kernel(const b4::Params p) {
  using namespace b4;
  extern __shared__ __align__(128) int8_t ring[];  // STAGES x (A, B)
  __shared__ float sS[BM];
  __shared__ Seg sg[2];  // the segments, indexed by a runtime segment

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (tid == 0) {
    sg[0] = p.seg[0];
    sg[1] = p.seg[NSEG - 1];
  }
  __syncthreads();
  const int kst0 = p.seg[0].kst;
  const int ktot = kst0 + (NSEG == 2 ? p.seg[1].kst : 0);
  const bool split = gridDim.z > 1;
  // this block's stages [fb, fe) of the list: segment 0's, then 1's
  int fb = 0, fe = ktot;
  if (split) {
    const int z = blockIdx.z;
    fb = z < p.pieces0 ? z * p.sps : kst0 + (z - p.pieces0) * p.sps;
    fe = min(z < p.pieces0 ? kst0 : ktot, fb + p.sps);
  }

  // copies: this thread's chunk column cc and rows r0 + RPP * j. Per A
  // row, once: the offset of its window's corner (b, ho*sh - pt, wo*sw -
  // pl) and a bit per tap whose pixel lies inside the image
  const int cc = tid % CPR, r0 = tid / CPR;
  long long abase[NA];
  uint32_t amask[NA];
  // the window corner of output pixel m: its image, top row, left column
  auto corner = [&](int m, int& b, int& hc, int& wc) {
    const int hw = p.Ho * p.Wo;
    b = m / hw;
    const int rem = m - b * hw, ho = rem / p.Wo;
    hc = ho * p.sh - p.pt, wc = (rem - ho * p.Wo) * p.sw - p.pl;
  };
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    const int m = m0 + r0 + RPP * j;
    int b, hc, wc;
    corner(m < p.M ? m : 0, b, hc, wc);
    abase[j] = (long long)b * p.sb + (long long)hc * p.srow +
               (long long)wc * p.spix;
    amask[j] = 0;
    if (m < p.M)
      for (int i = 0; i < p.kh; ++i)
        for (int jj = 0; jj < p.kw; ++jj)
          if (hc + i >= 0 && hc + i < p.H && wc + jj >= 0 && wc + jj < p.W)
            amask[j] |= 1u << (i * p.kw + jj);
  }

  // the walk: stage `lf` of the list is the next to load; within the
  // current segment `ls` this thread's chunk starts at value kk, which is
  // channel c of tap `tap` (tap offset toff); no division per stage
  int lf = fb, ls = -1, kk = 0, c = 0, tap = 0, jj = 0;
  long long toff = 0;
  const int8_t *cx = nullptr, *cw = nullptr;
  auto seg_start = [&](int s, int st) {  // the walk at stage st of seg s
    const Seg& S = sg[s];
    ls = s, cx = S.x, cw = S.w;
    kk = st * BK + cc * 16;
    tap = kk / S.C, c = kk - tap * S.C;
    const int i = tap / p.kw;
    jj = tap - i * p.kw;
    toff = (long long)i * p.srow + (long long)jj * p.spix;
  };

  auto load = [&](int slot) {  // stage lf into `slot`; the walk advances
    const int s = (NSEG == 2 && lf >= kst0) ? 1 : 0;
    if (s != ls) seg_start(s, lf - (s ? kst0 : 0));
    const Seg& S = sg[s];
    const int cK = S.K, cC = S.C, cpad = S.a_pad, cxvec = S.xvec;
    int8_t* sa = ring + slot * STAGE_BYTES;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      int8_t* dst = sa + (r0 + RPP * j) * LDS + cc * 16;
      if (kk >= cK || m0 + r0 + RPP * j >= p.M) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      } else if (cxvec) {  // 16 channels of one tap
        if (amask[j] >> tap & 1u) {
          cp16(smem_addr(dst), cx + abase[j] + toff + c, true);
        } else {
          const uint32_t v = 0x01010101u * (uint32_t)(cpad & 0xff);
          *reinterpret_cast<uint4*>(dst) = make_uint4(v, v, v, v);
        }
      } else {  // value by value
        int v[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          v[e] = 0;
          const int k = kk + e;
          if (k >= cK) continue;
          int b, hc, wc;
          corner(m0 + r0 + RPP * j, b, hc, wc);
          const int tp = k / cC, ch = k - tp * cC, i = tp / p.kw;
          const int h = hc + i, w = wc + tp - i * p.kw;
          v[e] = h < 0 || h >= p.H || w < 0 || w >= p.W
                     ? cpad
                     : cx[(long long)b * p.sb + (long long)h * p.srow +
                          (long long)w * p.spix + ch];
        }
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(pack4(v[0], v[1], v[2], v[3]),
                       pack4(v[4], v[5], v[6], v[7]),
                       pack4(v[8], v[9], v[10], v[11]),
                       pack4(v[12], v[13], v[14], v[15]));
      }
    }
    int8_t* sbt = sa + A_BYTES;  // B: rows n of w_t
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int nl = r0 + RPP * j, n = n0 + nl;
      int8_t* dst = sbt + nl * LDS + cc * 16;
      const size_t row = (size_t)n * cK;
      if (S.wvec) {
        const bool ok = n < p.N && kk < cK;
        cp16(smem_addr(dst), ok ? cw + row + kk : cw, ok);
      } else {
        int v[16];
#pragma unroll
        for (int e = 0; e < 16; ++e)
          v[e] = n < p.N && kk + e < cK ? cw[row + kk + e] : 0;
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(pack4(v[0], v[1], v[2], v[3]),
                       pack4(v[4], v[5], v[6], v[7]),
                       pack4(v[8], v[9], v[10], v[11]),
                       pack4(v[12], v[13], v[14], v[15]));
      }
    }
    ++lf, kk += BK, c += BK;  // the next stage: channel c + BK, or taps on
    while (c >= cC && cxvec) {
      c -= cC, ++tap, ++jj, toff += p.spix;
      if (jj == p.kw) jj = 0, toff += p.srow - (long long)p.kw * p.spix;
    }
  };

  int acc[MI][NI][4];
  float y[NSEG == 2 ? MI : 1][NSEG == 2 ? NI : 1][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int n = 0; n < NI; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0;
  int rsum = 0;  // row tid / 2 of the A tiles, values 32 * (tid % 2) ..

  // the epilogue of segment s into y (NSEG == 2) or the output
  auto finish_segment = [&](int s) {
    const int v = rsum + __shfl_xor_sync(0xffffffffu, rsum, 1);
    if (!(tid & 1)) sS[tid >> 1] = (float)v;  // exact: |S| < 2^24
    rsum = 0;
    __syncthreads();
    const Seg& S = sg[s];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int n = 0; n < NI; ++n)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int rl = wm * WM + i * 16 + g + 8 * q;
          const int nc = n0 + wn * WN + n * 8 + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = min(nc + e, p.N - 1);
            v[e] = affine(__int2float_rn(acc[i][n][2 * q + e]), S.A[c],
                          S.Bc[c], sS[rl], S.Cc[c]);
            acc[i][n][2 * q + e] = 0;
          }
          if constexpr (NSEG == 2) {
            if (s == 0) {
              y[i][n][2 * q] = v[0], y[i][n][2 * q + 1] = v[1];
              continue;
            }
            v[0] = __fadd_rn(y[i][n][2 * q], v[0]);
            v[1] = __fadd_rn(y[i][n][2 * q + 1], v[1]);
          }
          const int m = m0 + rl;
          if (m >= p.M || nc >= p.N) continue;
          if (p.bias) {
            v[0] = __fadd_rn(v[0], p.bias[nc]);
            if (nc + 1 < p.N) v[1] = __fadd_rn(v[1], p.bias[nc + 1]);
          }
          store_pair(p.y, p.y_bf16, p.N, m, nc, v[0], v[1]);
        }
  };

  const int nst = fe - fb;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s);
    cp_commit();
  }
  for (int it = 0; it < nst; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage `it` landed; every warp is done with it - 1
    if (it + STAGES - 1 < nst) load((it + STAGES - 1) % STAGES);
    cp_commit();
    const int8_t* sa = ring + (it % STAGES) * STAGE_BYTES;
    const int8_t* sbt = sa + A_BYTES;
    const int8_t* mine = sa + (tid >> 1) * LDS + (tid & 1) * (BK / 2);
#pragma unroll
    for (int q = 0; q < BK / 32; ++q)
      rsum += sum16(*reinterpret_cast<const uint4*>(mine + 16 * q));
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4(a[i], sa + (wm * WM + i * 16 + (lane & 15)) * LDS + ks * 32 +
                          (lane >> 4) * 16);
#pragma unroll
      for (int n = 0; n < NI; n += 2) {
        uint32_t r[4];
        ldsm_x4(r, sbt + (wn * WN + (n + (lane >> 4)) * 8 + (lane & 7)) *
                             LDS +
                       ks * 32 + ((lane >> 3) & 1) * 16);
        b[n][0] = r[0], b[n][1] = r[1], b[n + 1][0] = r[2],
        b[n + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int n = 0; n < NI; ++n) mma_s8(acc[i][n], a[i], b[n]);
    }
    const int f = fb + it;
    if (!split && (f == kst0 - 1 || f == ktot - 1))
      finish_segment(f >= kst0 ? 1 : 0);
  }
  cp_wait<0>();
  if (!split) return;

  // K split: int32 partials of this block's stages
  const int z = blockIdx.z;
  int* ws = p.ws + (size_t)z * p.M * p.N;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int n = 0; n < NI; ++n)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int m = m0 + wm * WM + i * 16 + g + 8 * q;
        const int nc = n0 + wn * WN + n * 8 + 2 * t;
        if (m >= p.M) continue;
        int* dst = ws + (size_t)m * p.N + nc;
        if (nc + 1 < p.N && p.N % 2 == 0) {
          *reinterpret_cast<int2*>(dst) =
              make_int2(acc[i][n][2 * q], acc[i][n][2 * q + 1]);
        } else {
          if (nc < p.N) dst[0] = acc[i][n][2 * q];
          if (nc + 1 < p.N) dst[1] = acc[i][n][2 * q + 1];
        }
      }
  if (blockIdx.x == 0) {
    const int v = rsum + __shfl_xor_sync(0xffffffffu, rsum, 1);
    const int m = m0 + (tid >> 1);
    if (!(tid & 1) && m < p.M)
      p.ws[(size_t)p.splits * p.M * p.N + (size_t)z * p.M + m] = v;
  }
}

// The K splits of int8_conv_kernel added (int32, exact in any order) and
// the epilogue applied once: one thread per output
__global__ void __launch_bounds__(256)
    int8_conv_reduce_kernel(const b4::Params p) {
  const size_t mn = (size_t)p.M * p.N;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  const int m = (int)(idx / p.N), n = (int)(idx % p.N);
  const int* wsS = p.ws + (size_t)p.splits * mn;
  float y = 0.f;
  for (int s = 0; s < p.nseg; ++s) {
    const float* A = s ? p.seg[1].A : p.seg[0].A;
    const float* Bc = s ? p.seg[1].Bc : p.seg[0].Bc;
    const float* Cc = s ? p.seg[1].Cc : p.seg[0].Cc;
    const int z0 = s ? p.pieces0 : 0, z1 = s ? p.splits : p.pieces0;
    int a = 0, sum = 0;
    for (int z = z0; z < z1; ++z) {
      a += p.ws[(size_t)z * mn + idx];
      sum += wsS[(size_t)z * p.M + m];
    }
    const float v = affine(__int2float_rn(a), A[n], Bc[n], (float)sum, Cc[n]);
    y = s ? __fadd_rn(y, v) : v;
  }
  if (p.bias) y = __fadd_rn(y, p.bias[n]);
  if (p.y_bf16)
    static_cast<bf16*>(p.y)[idx] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(p.y)[idx] = y;
}

template <int NSEG, int MINB>
int launch_conv(const b4::Params& p, cudaStream_t st) {
  auto kern = int8_conv_kernel<NSEG, MINB>;
  static unsigned raised = 0;  // bit d: the shared memory limit raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(raised >> dev & 1u)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, b4::SMEM);
    if (err != cudaSuccess) return (int)err;
    raised |= 1u << dev;
  }
  const dim3 grid((p.N + b4::BN - 1) / b4::BN, (p.M + b4::BM - 1) / b4::BM,
                  p.splits);
  kern<<<grid, b4::THREADS, b4::SMEM, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const size_t n = (size_t)p.M * p.N;
  int8_conv_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) { return (uintptr_t)ptr % 16 == 0; }

}  // namespace

// B4: int8_quantize_kernel (for f32 / bf16 x) and one int8_conv_kernel
// launch (plus int8_conv_reduce_kernel when the plan splits K), described
// by `d`, an array of int64 indexed by DescField and, for segment s, by
// D_SEG + s * S_FIELDS + SegField: pointers as integers, the clamp range,
// centre and pad value of each segment's quantizer as integers. x: the
// first channel of segment s at X (segment 1's channels follow segment
// 0's), NHWC with element strides SB, SROW, SPIX. xtype: 0 f32 x, 1 bf16
// x (quantized into XQ, an int8 buffer of B*H*W*(C0 + C1) values), 2 int8
// x (one segment, already quantized). ops/int8_conv.py builds the array
// by these names. Launches on `stream`; returns the first CUDA error (0
// on success).
enum DescField {
  D_NSEG, D_XTYPE, D_M, D_N, D_H, D_W, D_HO, D_WO, D_KH, D_KW, D_SH, D_SW,
  D_PT, D_PL, D_SB, D_SROW, D_SPIX, D_Y, D_YBF16, D_BIAS, D_WS, D_XQ,
  D_SPLITS, D_SPS, D_PIECES0, D_SEG
};
enum SegField {
  S_X, S_W, S_A, S_BC, S_CC, S_DELTA, S_ZP, S_LO, S_HI, S_CENTER, S_PAD,
  S_C, S_FIELDS
};

extern "C" int qdt_int8_conv(const long long* d, void* stream) {
  using namespace b4;
  const int bad = (int)cudaErrorInvalidValue;
  const int nseg = (int)d[D_NSEG], xt = (int)d[D_XTYPE];
  if (nseg < 1 || nseg > 2 || xt < 0 || xt > 2 || (xt == 2 && nseg != 1))
    return bad;
  Params p{};
  p.nseg = nseg;
  p.M = (int)d[D_M], p.N = (int)d[D_N], p.H = (int)d[D_H];
  p.W = (int)d[D_W], p.Ho = (int)d[D_HO], p.Wo = (int)d[D_WO];
  p.kh = (int)d[D_KH], p.kw = (int)d[D_KW], p.sh = (int)d[D_SH];
  p.sw = (int)d[D_SW], p.pt = (int)d[D_PT], p.pl = (int)d[D_PL];
  p.sb = d[D_SB], p.srow = d[D_SROW], p.spix = d[D_SPIX];
  p.y = (void*)d[D_Y], p.y_bf16 = (int)d[D_YBF16];
  p.bias = (const float*)d[D_BIAS], p.ws = (int*)d[D_WS];
  p.splits = (int)d[D_SPLITS], p.sps = (int)d[D_SPS];
  p.pieces0 = (int)d[D_PIECES0];
  if (p.M <= 0 || p.N <= 0 || p.H <= 0 || p.W <= 0 || p.Ho <= 0 ||
      p.Wo <= 0 || p.kh <= 0 || p.kw <= 0 || p.sh <= 0 || p.sw <= 0 ||
      p.pt < 0 || p.pl < 0 || p.kh * p.kw > 32 || p.M % (p.Ho * p.Wo) ||
      !p.y ||
      (p.M + BM - 1) / BM > 65535)
    return bad;
  QParams q{};
  const void* x0 = nullptr;
  int pieces = 0, ct = 0;
  for (int s = 0; s < nseg; ++s) {
    const long long* e = d + D_SEG + s * S_FIELDS;
    Seg& S = p.seg[s];
    if (s == 0) x0 = (const void*)e[S_X];
    S.x = (const int8_t*)e[S_X], S.w = (const int8_t*)e[S_W];
    S.A = (const float*)e[S_A], S.Bc = (const float*)e[S_BC];
    S.Cc = (const float*)e[S_CC], S.a_pad = (int)e[S_PAD];
    S.C = (int)e[S_C];
    S.K = p.kh * p.kw * S.C;
    S.kst = (S.K + BK - 1) / BK;
    const float* dl = (const float*)e[S_DELTA];
    const float* zp = (const float*)e[S_ZP];
    if (s == 0) {
      q.d0 = q.d1 = dl, q.z0 = q.z1 = zp;
      q.lo0 = q.lo1 = (float)e[S_LO], q.hi0 = q.hi1 = (float)e[S_HI];
      q.ctr0 = q.ctr1 = (float)e[S_CENTER];
    } else {
      q.d1 = dl, q.z1 = zp, q.lo1 = (float)e[S_LO];
      q.hi1 = (float)e[S_HI], q.ctr1 = (float)e[S_CENTER];
    }
    if (S.C <= 0 || !S.x || !S.w || !S.A || !S.Bc || !S.Cc ||
        (xt != 2 && (!dl || !zp)))
      return bad;
    ct += S.C;
    if (p.splits > 1) {
      if (p.sps <= 0) return bad;
      pieces += (S.kst + p.sps - 1) / p.sps;
      if (s == 0 && pieces != p.pieces0) return bad;
    }
  }
  if (p.splits < 1 || p.splits > 65535 ||
      (p.splits > 1 && (pieces != p.splits || !p.ws)))
    return bad;
  if (p.splits == 1) p.pieces0 = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xt != 2) {  // quantize x once into XQ, contiguous NHWC int8
    int8_t* xq = (int8_t*)d[D_XQ];
    if (!xq) return bad;
    const long long pix = (long long)(p.M / (p.Ho * p.Wo)) * p.H * p.W;
    q.x = x0, q.xq = xq, q.sb = p.sb, q.srow = p.srow, q.spix = p.spix;
    q.HW = p.H * p.W, q.W = p.W, q.C0 = p.seg[0].C, q.Ct = ct;
    const long long ew = xt == 0 ? 4 : 2;
    q.vec = ct % 8 == 0 && q.C0 % 8 == 0 && aligned16(x0) &&
            (p.sb * ew) % 16 == 0 && (p.srow * ew) % 16 == 0 &&
            (p.spix * ew) % 16 == 0;
    if (pix * ct >= (1ll << 31)) return bad;
    q.total = (int)(pix * ct / (q.vec ? 8 : 1));
    const unsigned blocks = (unsigned)((q.total + 255) / 256);
    if (xt == 1)
      int8_quantize_kernel<bf16><<<blocks, 256, 0, st>>>(q);
    else
      int8_quantize_kernel<float><<<blocks, 256, 0, st>>>(q);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    p.seg[0].x = xq;
    if (nseg == 2) p.seg[1].x = xq + p.seg[0].C;
    p.sb = (long long)p.H * p.W * ct, p.srow = (long long)p.W * ct;
    p.spix = ct;
  }
  for (int s = 0; s < nseg; ++s) {
    Seg& S = p.seg[s];
    S.xvec = S.C % 16 == 0 && aligned16(S.x) && p.sb % 16 == 0 &&
             p.srow % 16 == 0 && p.spix % 16 == 0;
    S.wvec = S.K % 16 == 0 && aligned16(S.w);
  }
  if (nseg == 1) p.seg[1] = p.seg[0];
  return nseg == 1 ? launch_conv<1, 2>(p, st) : launch_conv<2, 1>(p, st);
}

// B5 (int4 = 0): w (K, N) int8. B6 (int4 = 1): w (K/2, N) uint8 nibble
// pack, K even. x: (M, K) f32 (x_bf16 = 0) or bf16; scale / shift / cnst:
// (N,) f32; y: (M, N) f32 (y_bf16 = 0) or bf16; all contiguous on one
// device. The launch plan (the wrapper's `stream_plan`): bm, the rows of
// the block's tile (16 or 32, by 128 columns); splits, the number of K
// splits; kps, the weight rows per split (a multiple of a stage's
// 64 / (1 + int4) rows, covering w's rows with no empty split). ws:
// splits > 1, an f32 workspace of splits * M * (N + 1) values; else
// unused. Launches on `stream`; returns the first CUDA error (0 on
// success).
extern "C" int qdt_stream_matmul(const void* x, const void* w,
                                 const float* scale, const float* shift,
                                 const float* cnst, void* y, float* ws,
                                 int M, int N, int K, int x_bf16, int int4,
                                 int y_bf16, int bm, int splits, int kps,
                                 void* stream) {
  const int kw = int4 ? K / 2 : K;
  const int stage_rows = XSTAGE / (int4 ? 2 : 1);
  if (M <= 0 || N <= 0 || K <= 0 || (int4 && K % 2) || bm <= 0 ||
      (M + bm - 1) / bm > 65535 || splits < 1 || splits > 65535 ||
      kps <= 0 || kps % stage_rows || (long long)(splits - 1) * kps >= kw ||
      (long long)splits * kps < kw || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int es = x_bf16 ? 2 : 4;
  SParams p{x, static_cast<const uint8_t*>(w), scale, shift, cnst, y, ws,
            M, N, K, kw, kps,
            (K * es) % 16 == 0 && (kw * es) % 16 == 0 && aligned16(x) &&
                N % 16 == 0 && aligned16(w),
            y_bf16};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return int4 ? launch_stream_tile<bf16, 2>(p, bm, splits, st)
                : launch_stream_tile<bf16, 1>(p, bm, splits, st);
  return int4 ? launch_stream_tile<float, 2>(p, bm, splits, st)
              : launch_stream_tile<float, 1>(p, bm, splits, st);
}
