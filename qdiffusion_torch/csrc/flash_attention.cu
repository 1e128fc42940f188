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
// wrappers do). f32 inputs keep every product in f32 (plain FMA, no TF32).
// P's modes replace the `otherwise` line by its own transforms of p
// (`epilogue` below; the port's ops/flash_epilogue.py lists them).
//
// fq is the TPU kernels' `_fq` (flash_attention.py:61-84): it multiplies by
// 1/delta, rounds half to even (rintf), and has three clip branches
// (symmetric; nonneg and always_zero: upper clip only; otherwise [0, n-1]).
//
// Two designs share this file:
//   flash_mma_kernel  bf16 inputs with D <= 128: every B2 site of the SD
//                     fold path, B3 at D <= 128, and P (D <= 48);
//   flash_kernel      f32 inputs (B2 on the stream engine's f32 path) and
//                     D > 128 (B3 at the VAE's D = 512), redesigned later.
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
// flash_kernel, the first design (simple and right first): one block of
// 256 threads per (q-tile, batch*head). The q-tile stays in shared memory;
// pass 1 streams K blocks and keeps the running (max, sum-exp) per row;
// pass 2 streams K and V blocks again, forms p in shared memory and
// accumulates the f32 output tile in shared memory. bf16 products use WMMA
// 16x16x16 with f32 accumulation, f32 inputs plain FMA. At D = 512 the
// q-tile shrinks to 32 rows so that the f32 output tile fits. Tiles come
// from device memory in 16-byte loads where D and the pointers allow it
// (D = 40, 80, 512 do). It pays two exponentials per score and round-trips
// the score, p and output tiles through shared memory; at the VAE shape
// (D = 512) the two QK^T passes and one PV on the tensor cores bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegBig = -1e30f;  // masked scores (flash_streaming.py:39)
constexpr int kSmemMax = 232448;   // per-block limit on sm_90

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const float* sm;  // device [delta, zero_point] of the softmax quantizer
  int T, S, H, D, DP;
  int bm, ld;  // q-tile rows, smem row stride of Q/KV
  int vec;     // 1: rows load as 16-byte vectors
  float scale;
  int n_levels, symmetric, always_zero;
  int off_q, off_kv, off_s, off_p, off_o, off_m, off_l;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// key-block rows: a compile-time constant per input type; the score tile's
// row stride is padded by 4 floats so that rows fall in other banks
template <typename T>
constexpr int kBN = std::is_same<T, bf16>::value ? 64 : 32;
template <typename T>
constexpr int kLS = kBN<T> + 4;

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

// rows [0, rows) of one (b, h) slice of a (B, L, H, D) tensor into a
// (rows, ld) shared tile, zero beyond L and beyond D
template <typename T>
__device__ void load_tile(T* dst, const T* src, int row0, int rows, int L,
                          const Params& p) {
  const size_t stride = (size_t)p.H * p.D;
  if (p.vec) {  // D is a multiple of the vector and rows are aligned
    constexpr int V = 16 / sizeof(T);
    const int nv = p.DP / V;
    for (int idx = threadIdx.x; idx < rows * nv; idx += kThreads) {
      int r = idx / nv, d = (idx - r * nv) * V;
      int t = row0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (t < L && d < p.D)
        val = *reinterpret_cast<const uint4*>(src + (size_t)t * stride + d);
      if constexpr (std::is_same<T, bf16>::value) {
        *reinterpret_cast<uint4*>(dst + r * p.ld + d) = val;
      } else {  // f32 rows have an odd stride: store lane by lane
        const float* f = reinterpret_cast<const float*>(&val);
        for (int i = 0; i < V; ++i) dst[r * p.ld + d + i] = f[i];
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < rows * p.DP; idx += kThreads) {
    int r = idx / p.DP, d = idx - r * p.DP;
    int t = row0 + r;
    T val = from_f<T>(0.f);
    if (t < L && d < p.D) val = src[(size_t)t * stride + d];
    dst[r * p.ld + d] = val;
  }
}

// Ss (bm, bn) f32, row stride kLS = Qs (bm, DP) . Ks (bn, DP)^T
template <typename T>
__device__ void qk_tile(const Params& p, const T* Qs, const T* Ks,
                        float* Ss) {
  constexpr int BN = kBN<T>, LS = kLS<T>;
  const int warp = threadIdx.x / 32;
  if constexpr (std::is_same<T, bf16>::value) {
    const int tn_n = BN / 16, tiles = (p.bm / 16) * tn_n;
    for (int t = warp; t < tiles; t += kWarps) {
      int tm = t / tn_n, tn = t - tm * tn_n;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < p.DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + tm * 16 * p.ld + kk, p.ld);
        wmma::load_matrix_sync(b, Ks + tn * 16 * p.ld + kk, p.ld);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ss + tm * 16 * LS + tn * 16, acc, LS,
                              wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < p.bm * BN; idx += kThreads) {
      int r = idx / BN, j = idx - r * BN;
      const float* qr = Qs + r * p.ld;
      const float* kr = Ks + j * p.ld;
      float acc = 0.f;
      for (int d = 0; d < p.D; ++d) acc = fmaf(qr[d], kr[d], acc);
      Ss[r * LS + j] = acc;
    }
  }
}

// Os (bm, DP) f32 += Ps (bm, bn) . Vs (bn, DP)
template <typename T>
__device__ void pv_tile(const Params& p, const T* Ps, const T* Vs,
                        float* Os) {
  constexpr int BN = kBN<T>;
  const int warp = threadIdx.x / 32;
  if constexpr (std::is_same<T, bf16>::value) {
    const int tn_n = p.DP / 16, tiles = (p.bm / 16) * tn_n;
    for (int t = warp; t < tiles; t += kWarps) {
      int tm = t / tn_n, tn = t - tm * tn_n;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* out = Os + tm * 16 * p.DP + tn * 16;
      wmma::load_matrix_sync(acc, out, p.DP, wmma::mem_row_major);
      for (int kk = 0; kk < BN; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Ps + tm * 16 * BN + kk, BN);
        wmma::load_matrix_sync(b, Vs + kk * p.ld + tn * 16, p.ld);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(out, acc, p.DP, wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < p.bm * p.DP; idx += kThreads) {
      int r = idx / p.DP, d = idx - r * p.DP;
      if (d >= p.D) continue;
      const float* pr = Ps + r * BN;
      float acc = Os[idx];
      for (int j = 0; j < BN; ++j) acc = fmaf(pr[j], Vs[j * p.ld + d], acc);
      Os[idx] = acc;
    }
  }
}

template <typename T, bool SMQ, bool NORM_AFTER>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const Params p) {
  constexpr int BN = kBN<T>, LS = kLS<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + p.off_q);
  T* KVs = reinterpret_cast<T*>(smem + p.off_kv);
  float* Ss = reinterpret_cast<float*>(smem + p.off_s);
  T* Ps = reinterpret_cast<T*>(smem + p.off_p);
  float* Os = reinterpret_cast<float*>(smem + p.off_o);
  float* Mr = reinterpret_cast<float*>(smem + p.off_m);
  float* Lr = reinterpret_cast<float*>(smem + p.off_l);

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int t0 = blockIdx.x * p.bm;
  const size_t hd = (size_t)h * p.D;
  const T* qb = static_cast<const T*>(p.q) + (size_t)b * p.T * p.H * p.D + hd;
  const T* kb = static_cast<const T*>(p.k) + (size_t)b * p.S * p.H * p.D + hd;
  const T* vb = static_cast<const T*>(p.v) + (size_t)b * p.S * p.H * p.D + hd;
  T* ob = static_cast<T*>(p.o) + (size_t)b * p.T * p.H * p.D + hd;
  // pass 1 gives each row tpr neighbouring threads (a power of two that
  // divides 32), each of them every tpr-th column of the key block
  const int tpr = kThreads / p.bm;
  const int row = threadIdx.x / tpr, part = threadIdx.x % tpr;

  load_tile<T>(Qs, qb, t0, p.bm, p.T, p);
  for (int r = threadIdx.x; r < p.bm; r += kThreads) {
    Mr[r] = kNegBig;
    Lr[r] = 0.f;
  }
  for (int idx = threadIdx.x; idx < p.bm * p.DP; idx += kThreads) Os[idx] = 0.f;
  __syncthreads();

  // pass 1: running (max, sum-exp) per row (flash_streaming.py:42-71)
  for (int s0 = 0; s0 < p.S; s0 += BN) {
    load_tile<T>(KVs, kb, s0, BN, p.S, p);
    __syncthreads();
    qk_tile<T>(p, Qs, KVs, Ss);
    __syncthreads();
    {
      const float* sr = Ss + row * LS;
      float mx = kNegBig;
      for (int j = part; j < BN; j += tpr)
        if (s0 + j < p.S) mx = fmaxf(mx, sr[j] * p.scale);
      for (int o = tpr / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = Mr[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = part; j < BN; j += tpr)
        if (s0 + j < p.S) sum += expf(sr[j] * p.scale - m_new);
      for (int o = tpr / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (part == 0) {
        Lr[row] = Lr[row] * expf(m_old - m_new) + sum;
        Mr[row] = m_new;
      }
    }
    __syncthreads();
  }
  for (int r = threadIdx.x; r < p.bm; r += kThreads) Lr[r] = 1.f / Lr[r];
  float delta = 0.f, inv_delta = 0.f, zp = 0.f;
  if constexpr (SMQ) {
    delta = p.sm[0];
    zp = p.sm[1];
    inv_delta = 1.f / delta;
  }
  __syncthreads();

  // pass 2: out += p . v over key blocks, p formed in shared memory
  for (int s0 = 0; s0 < p.S; s0 += BN) {
    load_tile<T>(KVs, kb, s0, BN, p.S, p);
    __syncthreads();
    qk_tile<T>(p, Qs, KVs, Ss);
    __syncthreads();
    load_tile<T>(KVs, vb, s0, BN, p.S, p);
    for (int idx = threadIdx.x; idx < p.bm * BN; idx += kThreads) {
      int r = idx / BN, j = idx - r * BN;
      float e = s0 + j < p.S ? expf(Ss[r * LS + j] * p.scale - Mr[r]) : 0.f;
      float pv;
      if constexpr (NORM_AFTER) {
        pv = e;  // flash_attention.py:117-124: normaliser after PV
      } else {
        pv = e * Lr[r];
        if constexpr (std::is_same<T, bf16>::value)
          pv = __bfloat162float(__float2bfloat16(pv));
        if constexpr (SMQ)
          pv = fq(pv, delta, inv_delta, zp, p.n_levels, p.symmetric,
                  p.always_zero);
      }
      Ps[idx] = from_f<T>(pv);
    }
    __syncthreads();
    pv_tile<T>(p, Ps, KVs, Os);
    __syncthreads();
  }

  const size_t stride = (size_t)p.H * p.D;
  for (int idx = threadIdx.x; idx < p.bm * p.DP; idx += kThreads) {
    int r = idx / p.DP, d = idx - r * p.DP;
    int t = t0 + r;
    if (t >= p.T || d >= p.D) continue;
    float val = Os[idx];
    if constexpr (NORM_AFTER) val *= Lr[r];
    ob[(size_t)t * stride + d] = from_f<T>(val);
  }
}

int align128(int x) { return (x + 127) & ~127; }

template <typename T, bool SMQ, bool NORM_AFTER>
int launch(Params& p, int grid_x, int grid_y, int smem, cudaStream_t st) {
  auto kern = flash_kernel<T, SMQ, NORM_AFTER>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(grid_x, grid_y), kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
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

}  // namespace

// q: (B, T, H, D), k, v: (B, S, H, D), o: (B, T, H, D), all contiguous,
// bf16 (is_bf16 = 1) or f32. sm: device pointer to [delta, zero_point]
// when sm_on, else ignored. norm_before = 1 selects B3's function (the
// normaliser before PV even without sm_q), 0 B2's. bf16 with D <= 128 runs
// flash_mma_kernel, the rest flash_kernel. Launches on `stream` and
// returns the CUDA error of the launch (0 on success).
extern "C" int qdt_flash_attention(const void* q, const void* k,
                                   const void* v, void* o, const float* sm,
                                   int B, int T, int S, int H, int D,
                                   float scale, int is_bf16, int sm_on,
                                   int n_levels, int symmetric,
                                   int always_zero, int norm_before,
                                   void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || D <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (is_bf16 && D <= 128) {
    mmad::Params mp = mmad::make_params(q, k, v, o, T, S, H, D, scale);
    mp.sm = sm;
    mp.n_levels = n_levels;
    mp.symmetric = symmetric;
    mp.always_zero = always_zero;
    const int epi = sm_on ? mmad::kSmq
                          : (norm_before ? mmad::kCastRt : mmad::kPostNorm);
    return mmad::launch_epi(mp, epi, B, H, static_cast<cudaStream_t>(stream));
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.sm = sm;
  p.T = T;
  p.S = S;
  p.H = H;
  p.D = D;
  p.DP = (D + 15) / 16 * 16;
  p.scale = scale;
  p.n_levels = n_levels;
  p.symmetric = symmetric;
  p.always_zero = always_zero;
  const int es = is_bf16 ? 2 : 4;
  const int bn = is_bf16 ? kBN<bf16> : kBN<float>;
  const int ls = is_bf16 ? kLS<bf16> : kLS<float>;
  if (is_bf16) {
    p.bm = p.DP <= 160 ? 64 : 32;
    p.ld = p.DP;  // WMMA: 16-element rows, 32-byte aligned tiles
  } else {
    p.bm = p.DP <= 160 ? 32 : 16;
    p.ld = p.DP + 1;  // odd stride: K rows read by a warp miss no bank
  }
  // 16-byte loads: D a multiple of the vector, every row start aligned
  const int vec_elems = 16 / es;
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  p.vec = D % vec_elems == 0 && (H * D) % vec_elems == 0 && addr % 16 == 0
          && p.DP % vec_elems == 0;
  int off = 0;
  p.off_q = off;
  off += align128(p.bm * p.ld * es);
  p.off_kv = off;
  off += align128(bn * p.ld * es);
  p.off_s = off;
  off += align128(p.bm * ls * 4);
  p.off_p = off;
  off += align128(p.bm * bn * es);
  p.off_o = off;
  off += align128(p.bm * p.DP * 4);
  p.off_m = off;
  off += align128(p.bm * 4);
  p.off_l = off;
  off += align128(p.bm * 4);
  if (off > kSmemMax) return (int)cudaErrorInvalidValue;

  const int gx = (T + p.bm - 1) / p.bm, gy = B * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool after = !norm_before && !sm_on;
  if (is_bf16) {
    if (sm_on) return launch<bf16, true, false>(p, gx, gy, off, st);
    if (after) return launch<bf16, false, true>(p, gx, gy, off, st);
    return launch<bf16, false, false>(p, gx, gy, off, st);
  }
  if (sm_on) return launch<float, true, false>(p, gx, gy, off, st);
  if (after) return launch<float, false, true>(p, gx, gy, off, st);
  return launch<float, false, false>(p, gx, gy, off, st);
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
