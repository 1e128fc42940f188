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
// The wrappers are qdiffusion_torch/ops/int8_matmul.py (B4, B5) and
// qdiffusion_torch/ops/int4_matmul.py (B6).
//
// The function, per output element (m, n), with S(x)[m] the row sum of x:
//   B4  acc = sum_k x_c[m,k] * w_c[k,n]   (int8 x int8, exact int32)
//       y   = A[n]*float(acc) + Bc[n]*S(x_c)[m] + C[n]            f32 out
//   B5  acc = sum_k bf16(x)[m,k] * w_c[k,n]   (int8 w, exact in bf16)
//       y   = scale[n]*acc + shift[n]*S(bf16(x))[m] + const[n]
//   B6  as B5 with w the nibbles of a (K/2, N) uint8 pack: the low nibble
//       of packed row k is row k of w, the high nibble row k + K/2
//       (int4_matmul.py:29-33).
// B5/B6 take f32 or bf16 x and round it to bf16 (nearest even) as they
// build its MMA fragments (the TPU wrappers' x.astype(bfloat16),
// int8_matmul.py:243, int4_matmul.py:160); products are bf16 MMAs with f32
// sums; y is f32 or bf16. The epilogue uses round-to-nearest multiplies
// and adds in the plain versions' order ((a*b) + (c*d)) + e, with no FMA
// contraction, so a B4 output equals its plain version bit for bit.
//
// What bounds it on an H100: at the CIFAR int8 shapes (M = 64*H*W up to
// 65,536 patch rows, K up to 3,456) the int8 tensor-core rate; at the SD
// stream shapes of batch 2 (M = 2 ... 8,192 rows) the weight bytes where
// M is small (time-embedding linears at M = 2, context projections at
// 154, the 8x8 convs at 128) and the x bytes and bf16 tensor-core rate
// at M >= 2,048.
//
// B4 (simple and right first): one block of 256 threads per 64 x 128
// output tile, 8 warps in a 2 x 4 grid of 32 x 32 warp tiles. The TPU's
// sequential K grid axis becomes a loop inside the block: each step
// stages one K slice of x and w in shared memory and runs WMMA on it
// (signed char fragments, int accumulator, m16n16k16). The int8 tiles sit
// in shared memory as 16 x 16 blocks so that every fragment starts on a
// 256-byte boundary. Each block sums its own x rows for S(x) while
// staging them, and the epilogue applies the per-column affine.
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
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int BM = 64, BN = 128;  // B4: block tile
constexpr int BK8 = 64;           // B4: K per stage (4 WMMA k-steps)

struct Params {  // B4
  const void* x;       // (M, K) int8
  const void* w;       // (K, N) int8
  const float* scale;  // (N,) A
  const float* shift;  // (N,) Bc
  const float* cnst;   // (N,) C
  void* y;             // (M, N) f32, or bf16 when y_bf16
  int M, N, K;         // K: columns of x
  int kw;              // rows of w: K
  int x_vec, w_vec;    // 16-byte loads allowed (strides and pointers)
  int y_bf16;
};

__device__ __forceinline__ float affine(float acc, float s, float b,
                                        float sum, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(acc, s), __fmul_rn(sum, b)), c);
}

__device__ __forceinline__ void store_y(const Params& p, int m, int n,
                                        float v) {
  const size_t i = (size_t)m * p.N + n;
  if (p.y_bf16)
    static_cast<bf16*>(p.y)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p.y)[i] = v;
}

// 16 int8 values from row `row`, columns [col, col+16) of a (rows, cols)
// row-major matrix with row stride ld, zero outside it
__device__ __forceinline__ void load16_i8(int8_t* dst, const int8_t* src,
                                          int row, int col, int rows,
                                          int cols, int ld, int vec) {
  if (row < rows && vec && col + 16 <= cols) {
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(src + (size_t)row * ld + col);
    return;
  }
  for (int i = 0; i < 16; ++i)
    dst[i] = (row < rows && col + i < cols) ? src[(size_t)row * ld + col + i]
                                            : (int8_t)0;
}

// Row sums: the 4 neighbouring lanes that stage one row add their parts
template <typename T>
__device__ __forceinline__ T row_total(T part) {
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  return part;
}

// ---------------------------------------------------------------- B4 ----

__global__ void __launch_bounds__(kThreads) b4_kernel(const Params p) {
  // sA[kc][m][k]: rows of one 16-wide K slice; sB[kc][nb][k][n]: 16 x 16
  // blocks, so each WMMA fragment is a contiguous 256-byte block
  __shared__ __align__(128) int8_t sA[BK8 / 16][BM][16];
  __shared__ __align__(128) int8_t sB[BK8 / 16][BN / 16][16][16];
  __shared__ __align__(128) int sC[kThreads / 32][16][16];
  __shared__ float sS[BM];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int8_t* X = static_cast<const int8_t*>(p.x);
  const int8_t* W = static_cast<const int8_t*>(p.w);

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  // staging of x: thread -> (row ar, 16-byte chunk ac); 64 x 4 = 256
  const int ar = tid / (BK8 / 16), ac = tid % (BK8 / 16);
  int rsum = 0;
  for (int k0 = 0; k0 < p.K; k0 += BK8) {
    load16_i8(&sA[ac][ar][0], X, m0 + ar, k0 + ac * 16, p.M, p.K, p.K,
              p.x_vec);
    for (int idx = tid; idx < BK8 * (BN / 16); idx += kThreads) {
      const int kr = idx / (BN / 16), nc = idx % (BN / 16);
      load16_i8(&sB[kr / 16][nc][kr % 16][0], W, k0 + kr, n0 + nc * 16,
                p.K, p.N, p.N, p.w_vec);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 16; ++i) rsum += sA[ac][ar][i];
#pragma unroll
    for (int kk = 0; kk < BK8 / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &sA[kk][wm * 32 + i * 16][0], 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &sB[kk][wn * 2 + j][0][0], 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  rsum = row_total(rsum);
  if (ac == 0) sS[ar] = (float)rsum;  // exact: |S| <= 128 K < 2^24
  __syncthreads();

  int* scr = &sC[warp][0][0];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int rl = wm * 32 + i * 16 + e / 16;
        const int m = m0 + rl, n = n0 + wn * 32 + j * 16 + e % 16;
        if (m < p.M && n < p.N)
          store_y(p, m, n, affine((float)scr[e], p.scale[n], p.shift[n],
                                  sS[rl], p.cnst[n]));
      }
      __syncwarp();
    }
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

bool aligned16(const void* ptr) { return (uintptr_t)ptr % 16 == 0; }

dim3 grid_of(int M, int N) { return dim3((N + BN - 1) / BN, (M + BM - 1) / BM); }

bool bad_shape(int M, int N, int K) {
  return M <= 0 || N <= 0 || K <= 0 || (M + BM - 1) / BM > 65535;
}

}  // namespace

// B4. x_c: (M, K) int8, w_c: (K, N) int8, scale_a / scale_s / cnst: (N,)
// f32, y: (M, N) f32; all contiguous on one device. Launches on `stream`
// and returns the CUDA error of the launch (0 on success).
extern "C" int qdt_int8_matmul(const void* x_c, const void* w_c,
                               const float* scale_a, const float* scale_s,
                               const float* cnst, void* y, int M, int N,
                               int K, void* stream) {
  if (bad_shape(M, N, K)) return (int)cudaErrorInvalidValue;
  Params p{x_c, w_c, scale_a, scale_s, cnst, y, M, N, K, K,
           K % 16 == 0 && aligned16(x_c), N % 16 == 0 && aligned16(w_c), 0};
  b4_kernel<<<grid_of(M, N), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
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
