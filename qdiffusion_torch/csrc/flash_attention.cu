// Two-pass flash attention with exact static-delta quantization of the
// normalized softmax: kernels B2 and B3 of the port.
//
// Replaces, by function:
//   B2  qdiffusion_tpu/ops/pallas/flash_attention.py::flash_attention
//       (pallas_call :170, kernel body `_kernel` :87-135);
//   B3  qdiffusion_tpu/ops/pallas/flash_streaming.py::streaming_flash_attention
//       (pallas_calls :153 and :165, `_p1_kernel` / `_p2_kernel`).
// The wrappers are qdiffusion_torch/ops/flash_attention.py and
// qdiffusion_torch/ops/flash_streaming.py; both call qdt_flash_attention
// below and differ only in the compile-time switches it selects.
//
// The function, per (batch, head) and query row, over S keys:
//   s   = (q . k) * scale                   f32 (bf16 operands, f32 sums)
//   m,l = row max, sum exp(s - m)           online over key blocks
//   e   = exp(s - m)
//   B2 without sm_q:  o = (bf16(e) . v) * (1/l)     normalise after PV
//   otherwise:        p = e * (1/l); p = bf16(p) (bf16 inputs);
//                     p = fq(p) (sm_q); o = bf16(p) . v
// V arrives already fake-quantized (the wrappers hoist it, as the TPU
// wrappers do). f32 inputs keep every product in f32 (plain FMA, no TF32).
//
// fq is the TPU kernels' `_fq` (flash_attention.py:61-84): it multiplies by
// 1/delta, rounds half to even (rintf), and has three clip branches
// (symmetric; nonneg and always_zero: upper clip only; otherwise [0, n-1]).
//
// What bounds it on an H100: at the SD shapes (D = 40, 80) the exp unit.
// Each score costs one exp per pass, and a two-pass design pays it twice;
// the MMA work at D <= 80 is smaller. At the VAE shape (D = 512) the two
// QK^T passes and one PV on the tensor cores.
//
// Design (simple and right first; wgmma, TMA and a single pass are later
// work): one block of 256 threads per (q-tile, batch*head). The q-tile
// stays in shared memory; pass 1 streams K blocks and keeps the running
// (max, sum-exp) per row; pass 2 streams K and V blocks again, forms p
// in shared memory and accumulates the f32 output tile in shared memory.
// bf16 products use WMMA 16x16x16 (mma.sync) with f32 accumulation; D is
// zero-padded in shared memory to a multiple of 16 (40 -> 48). At D = 512
// the q-tile shrinks to 32 rows so that the f32 output tile fits. Tiles
// come from device memory in 16-byte loads where D and the pointers
// allow it (D = 40, 80, 512 do).

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

}  // namespace

// q: (B, T, H, D), k, v: (B, S, H, D), o: (B, T, H, D), all contiguous,
// bf16 (is_bf16 = 1) or f32. sm: device pointer to [delta, zero_point]
// when sm_on, else ignored. norm_before = 1 selects B3's function (the
// normaliser before PV even without sm_q), 0 B2's. Launches on `stream`
// and returns the CUDA error of the launch (0 on success).
extern "C" int qdt_flash_attention(const void* q, const void* k,
                                   const void* v, void* o, const float* sm,
                                   int B, int T, int S, int H, int D,
                                   float scale, int is_bf16, int sm_on,
                                   int n_levels, int symmetric,
                                   int always_zero, int norm_before,
                                   void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || D <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
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
