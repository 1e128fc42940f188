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
// B5/B6 take f32 or bf16 x and round it to bf16 while staging (the TPU
// wrappers' x.astype(bfloat16), int8_matmul.py:243, int4_matmul.py:160);
// products are bf16 MMAs with f32 sums; y is f32 or bf16. The epilogue
// uses round-to-nearest multiplies and adds in the plain versions' order
// ((a*b) + (c*d)) + e, with no FMA contraction, so a B4 output equals its
// plain version bit for bit.
//
// What bounds it on an H100: at the CIFAR int8 shapes (M = 64*H*W up to
// 65,536 patch rows, K up to 3,456) the int8 tensor-core rate; at the SD
// stream shapes of batch 2 (M = 128 ... 8,192 rows) the weight bytes where
// M is small (low-resolution convs, context projections) and the bf16
// tensor-core rate elsewhere.
//
// Design (simple and right first; wgmma, TMA, a pipelined ring of stages
// and split-K for the small-M shapes are later work): one block of 256
// threads per 64 x 128 output tile, 8 warps in a 2 x 4 grid of 32 x 32
// warp tiles. The TPU's sequential K grid axis becomes a loop inside the
// block: each step stages one K slice of x and w in shared memory and
// runs WMMA on it (B4: signed char fragments with an int accumulator,
// m16n16k16; B5/B6: bf16 fragments with an f32 accumulator). The int8
// tiles sit in shared memory as 16 x 16 blocks so that every fragment
// starts on a 256-byte boundary. Each block sums its own x rows for S(x)
// while staging them (repeated across the N blocks, which is cheap), and
// the epilogue applies the per-column affine and writes y once. Ragged M,
// N and K edges are masked while staging (zeros) and at the store; no
// operand is padded in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int BM = 64, BN = 128;  // block tile
constexpr int BK8 = 64;           // B4: K per stage (4 WMMA k-steps)
constexpr int BK = 32;            // B5/B6: K per stage (2 WMMA k-steps)
constexpr int kPadA = 8, kPadB = 8;  // bf16 row padding (16 bytes)

struct Params {
  const void* x;       // (M, K): int8 (B4), f32 or bf16 (B5/B6)
  const void* w;       // (kw, N): int8 (B4/B5), packed uint8 (B6)
  const float* scale;  // (N,) A / scale / delta
  const float* shift;  // (N,) Bc / shift / off
  const float* cnst;   // (N,) C / const
  void* y;             // (M, N) f32, or bf16 when y_bf16
  int M, N, K;         // K: columns of x
  int kw;              // rows of w: K (B4/B5), K/2 (B6)
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

__device__ __forceinline__ float load_f(const float* s, size_t i) {
  return s[i];
}
__device__ __forceinline__ float load_f(const bf16* s, size_t i) {
  return __bfloat162float(s[i]);
}

__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));  // nearest even
}
__device__ __forceinline__ float bits_to_f(uint32_t b) {
  return __uint_as_float(b << 16);  // a bf16's value, exactly
}

// 8 values of x (row `row`, columns [col, col+8) of the half that starts
// at column `base` and has p.kw columns) -> 8 bf16 in shared memory;
// returns the sum of the bf16 values
template <typename XT>
__device__ __forceinline__ float stage_x8(bf16* dst, const XT* X,
                                          const Params& p, int row,
                                          int base, int col) {
  const bool full = row < p.M && col + 8 <= p.kw && p.x_vec;
  const size_t off = (size_t)row * p.K + base + col;
  uint4 u;
  if (std::is_same<XT, bf16>::value && full) {
    u = *reinterpret_cast<const uint4*>(X + off);
  } else {
    float f[8];
    if (full) {  // f32 rows: two 16-byte loads
      const float4 a = *reinterpret_cast<const float4*>(X + off);
      const float4 b = *reinterpret_cast<const float4*>(X + off + 4);
      f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
      f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        f[i] = (row < p.M && col + i < p.kw) ? load_f(X, off + i) : 0.f;
    }
    u = make_uint4(bf16_bits(f[0]) | bf16_bits(f[1]) << 16,
                   bf16_bits(f[2]) | bf16_bits(f[3]) << 16,
                   bf16_bits(f[4]) | bf16_bits(f[5]) << 16,
                   bf16_bits(f[6]) | bf16_bits(f[7]) << 16);
  }
  *reinterpret_cast<uint4*>(dst) = u;
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s += bits_to_f(w[i] & 0xFFFFu) + bits_to_f(w[i] >> 16);
  return s;
}

// NH = 1: B5 (int8 w). NH = 2: B6 (nibble pack; half h of the K walk
// reads x columns [h*kw, (h+1)*kw) against nibble h of the pack)
template <typename XT, int NH>
__global__ void __launch_bounds__(kThreads) stream_kernel(const Params p) {
  __shared__ __align__(128) bf16 sA[NH][BM][BK + kPadA];
  __shared__ __align__(128) bf16 sB[NH][BK][BN + kPadB];
  __shared__ __align__(128) float sC[kThreads / 32][16][16];
  __shared__ float sS[BM];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const XT* X = static_cast<const XT*>(p.x);
  const uint8_t* W = static_cast<const uint8_t*>(p.w);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // staging of x: thread -> (row ar, 8-column chunk ac); 64 x 4 = 256
  const int ar = tid / (BK / 8), ac = (tid % (BK / 8)) * 8;
  // staging of w: thread -> (row br, 16-column chunk bc); 32 x 8 = 256
  const int br = tid / (BN / 16), bc = (tid % (BN / 16)) * 16;
  float rsum = 0.f;
  for (int k0 = 0; k0 < p.kw; k0 += BK) {
#pragma unroll
    for (int h = 0; h < NH; ++h)
      rsum += stage_x8<XT>(&sA[h][ar][ac], X, p, m0 + ar, h * p.kw,
                           k0 + ac);
    {
      union {  // 16-byte aligned staging of 16 weight bytes
        uint4 u;
        uint8_t b[16];
      } wv;
      load16_i8(reinterpret_cast<int8_t*>(wv.b),
                reinterpret_cast<const int8_t*>(W), k0 + br, n0 + bc, p.kw,
                p.N, p.N, p.w_vec);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const uint8_t v = wv.b[i];
        if constexpr (NH == 1) {
          sB[0][br][bc + i] = __float2bfloat16_rn((float)(int8_t)v);
        } else {
          sB[0][br][bc + i] = __float2bfloat16_rn((float)(v & 0xF));
          sB[NH - 1][br][bc + i] = __float2bfloat16_rn((float)(v >> 4));
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], &sA[h][wm * 32 + i * 16][kk],
                                 BK + kPadA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], &sB[h][kk][wn * 32 + j * 16],
                                 BN + kPadB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    __syncthreads();
  }
  rsum = row_total(rsum);
  if (ac == 0) sS[ar] = rsum;
  __syncthreads();

  float* scr = &sC[warp][0][0];
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
          store_y(p, m, n, affine(scr[e], p.scale[n], p.shift[n], sS[rl],
                                  p.cnst[n]));
      }
      __syncwarp();
    }
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
// device. Launches on `stream`; returns the launch's CUDA error.
extern "C" int qdt_stream_matmul(const void* x, const void* w,
                                 const float* scale, const float* shift,
                                 const float* cnst, void* y, int M, int N,
                                 int K, int x_bf16, int int4, int y_bf16,
                                 void* stream) {
  if (bad_shape(M, N, K) || (int4 && K % 2)) return (int)cudaErrorInvalidValue;
  const int kw = int4 ? K / 2 : K;
  const int es = x_bf16 ? 2 : 4;
  Params p{x, w, scale, shift, cnst, y, M, N, K, kw,
           (K * es) % 16 == 0 && (kw * es) % 16 == 0 && aligned16(x),
           N % 16 == 0 && aligned16(w), y_bf16};
  const dim3 g = grid_of(M, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (int4)
      stream_kernel<bf16, 2><<<g, kThreads, 0, st>>>(p);
    else
      stream_kernel<bf16, 1><<<g, kThreads, 0, st>>>(p);
  } else {
    if (int4)
      stream_kernel<float, 2><<<g, kThreads, 0, st>>>(p);
    else
      stream_kernel<float, 1><<<g, kThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}
