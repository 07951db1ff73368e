// One frame of the ConvTWA recurrence on Hopper (sm_90a), CUDA C++.
//
// Replaces iip_uavsal_saliency_tpu/ops/pallas_twa.py::twa_scan_pallas (the
// Pallas TPU kernel). For every video v of a clip, one launch computes
//
//     g   = sigmoid(gx_s + conv3x3_same(h_{s-1}, W_h))
//     h_s = g * x_s + (1 - g) * h_{s-1}
//
// as an implicit GEMM: M = H*W output pixels, N = C output channels,
// K = 9*C (3x3 taps x input channels), accumulated in f32, with the
// sigmoid/lerp fused into the epilogue. The host launches frames in order
// (ops/twa.py); frame s reads h_{s-1} from ys[v, s-1] (or h0) and writes
// ys[v, s], so no ping-pong buffer is needed.
//
// What bounds it on an H100: at the flagship 45x80x256 one frame is
// 2*3600*2304*256 = 4.25 GFLOP against ~8.6 MB of x, gx, h_{s-1}, h_s and
// W_h, so it is compute-bound (about 4.3 us at the 989 TFLOP/s bf16 peak vs
// 2.6 us for the bytes at 3.35 TB/s). The TPU kernel kept h resident in
// VMEM across all frames; a Hopper block cannot hold the 1.8 MB h_{s-1}
// (227 KB of shared memory at most) and blocks share no state, so the
// design instead relies on the 50 MB L2 to keep h_{s-1}, W_h and the
// neighbouring frame data on chip between launches, and spends its effort
// on the tensor cores: bf16 runs on WMMA 16x16x16 tiles (f32 accumulate),
// with the next K slice prefetched into registers while the current one
// is multiplied. The f32 variant runs plain FMA (no TF32), for the f32
// serving path. wgmma, TMA and a persistent kernel are later work.
//
// Requirements (checked by the Python wrapper): C % 8 == 0, all pointers
// 16-byte aligned, tensors contiguous in (V, S, H, W, C) / (V, H, W, C)
// order, W_h contiguous in HWIO order (3, 3, C, C). Any H, W >= 1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

constexpr int BM = 64;   // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // input channels of one tap per K slice
constexpr int NT = 128;  // threads per block (4 warps)

template <typename T>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  static constexpr int LDA = BK + VEC;        // padded rows stay 16B-aligned
  static constexpr int LDB = BN + VEC;
  static constexpr int LDC = BN + 4;
  static constexpr int A_BYTES = BM * LDA * sizeof(T);
  static constexpr int B_BYTES = BK * LDB * sizeof(T);
  static constexpr int C_BYTES = BM * LDC * sizeof(float);
  static constexpr int SMEM =
      A_BYTES + B_BYTES > C_BYTES ? A_BYTES + B_BYTES : C_BYTES;
  static constexpr int AV = BM * BK / VEC / NT;  // 16B loads per thread (A)
  static constexpr int BV = BK * BN / VEC / NT;  // 16B loads per thread (B)
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Global -> registers for K slice `it` (tap = it / kchunks): A is BM pixels
// x BK channels of h_{s-1} shifted by the tap (zero outside the image, the
// conv's "same" padding); B is BK rows x BN columns of W_h.
template <typename T>
__device__ __forceinline__ void fetch(const T* __restrict__ hprev,
                                      const T* __restrict__ w, int it,
                                      int kchunks, int m0, int n0, int H,
                                      int W, int C, uint4 (&ra)[Tile<T>::AV],
                                      uint4 (&rb)[Tile<T>::BV]) {
  using TL = Tile<T>;
  const int tap = it / kchunks;
  const int c0 = (it % kchunks) * BK;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const int M = H * W;
#pragma unroll
  for (int q = 0; q < TL::AV; ++q) {
    const int i = threadIdx.x + q * NT;
    const int r = i / (BK / TL::VEC);
    const int c = c0 + (i % (BK / TL::VEC)) * TL::VEC;
    const int p = m0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (p < M && c < C) {
      const int py = p / W + dy, px = p % W + dx;
      if (py >= 0 && py < H && px >= 0 && px < W)
        val = *reinterpret_cast<const uint4*>(
            hprev + (static_cast<long long>(py) * W + px) * C + c);
    }
    ra[q] = val;
  }
#pragma unroll
  for (int q = 0; q < TL::BV; ++q) {
    const int i = threadIdx.x + q * NT;
    const int c = c0 + i / (BN / TL::VEC);
    const int n = n0 + (i % (BN / TL::VEC)) * TL::VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (c < C && n < C)
      val = *reinterpret_cast<const uint4*>(
          w + (static_cast<long long>(tap) * C + c) * C + n);
    rb[q] = val;
  }
}

template <typename T>
__device__ __forceinline__ void stash(T* As, T* Bs,
                                      const uint4 (&ra)[Tile<T>::AV],
                                      const uint4 (&rb)[Tile<T>::BV]) {
  using TL = Tile<T>;
#pragma unroll
  for (int q = 0; q < TL::AV; ++q) {
    const int i = threadIdx.x + q * NT;
    const int r = i / (BK / TL::VEC), cv = (i % (BK / TL::VEC)) * TL::VEC;
    *reinterpret_cast<uint4*>(As + r * TL::LDA + cv) = ra[q];
  }
#pragma unroll
  for (int q = 0; q < TL::BV; ++q) {
    const int i = threadIdx.x + q * NT;
    const int r = i / (BN / TL::VEC), nv = (i % (BN / TL::VEC)) * TL::VEC;
    *reinterpret_cast<uint4*>(Bs + r * TL::LDB + nv) = rb[q];
  }
}

// The block's BM x BN product, per element type.
template <typename T>
struct Acc;

// bf16: 4 warps in a 2x2 grid, each a 32x32 quadrant of 2x2 WMMA tiles.
template <>
struct Acc<__nv_bfloat16> {
  using TL = Tile<__nv_bfloat16>;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[2][2];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(f[i][j], 0.0f);
  }

  __device__ void run(const __nv_bfloat16* As, const __nv_bfloat16* Bs) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * TL::LDA + kk, TL::LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * TL::LDB + wn * 32 + j * 16, TL::LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(f[i][j], a[i], b[j], f[i][j]);
    }
  }

  __device__ void store(float* Cs) {
    const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::store_matrix_sync(
            Cs + (wm * 32 + i * 16) * TL::LDC + wn * 32 + j * 16, f[i][j],
            TL::LDC, nvcuda::wmma::mem_row_major);
  }
};

// f32: plain FMA, 8 rows x 4 columns per thread (columns strided by 16).
template <>
struct Acc<float> {
  using TL = Tile<float>;
  float f[8][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f[i][j] = 0.0f;
  }

  __device__ void run(const float* As, const float* Bs) {
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(tr * 8 + i) * TL::LDA + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k * TL::LDB + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) f[i][j] = fmaf(a[i], b[j], f[i][j]);
    }
  }

  __device__ void store(float* Cs) {
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(tr * 8 + i) * TL::LDC + tc + 16 * j] = f[i][j];
  }
};

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&out)[8]) {
  constexpr int VEC = Tile<T>::VEC;
#pragma unroll
  for (int q = 0; q < 8 / VEC; ++q) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + q * VEC);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[q * VEC + e] = to_f(t[e]);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&in)[8]) {
  constexpr int VEC = Tile<T>::VEC;
#pragma unroll
  for (int q = 0; q < 8 / VEC; ++q) {
    uint4 u;
    T* t = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int e = 0; e < VEC; ++e) t[e] = from_f<T>(in[q * VEC + e]);
    *reinterpret_cast<uint4*>(p + q * VEC) = u;
  }
}

// grid = (ceil(H*W / BM), ceil(C / BN), V). `vstride` steps x, gx and out
// from one video to the next, `hstride` steps h_{s-1}.
template <typename T>
__global__ void __launch_bounds__(NT)
    twa_step_kernel(const T* __restrict__ x, const T* __restrict__ gx,
                    const T* __restrict__ hprev, const T* __restrict__ w,
                    T* __restrict__ out, long long vstride, long long hstride,
                    int H, int W, int C) {
  using TL = Tile<T>;
  __shared__ __align__(128) unsigned char smem[TL::SMEM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + TL::A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int M = H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long v = blockIdx.z;
  x += v * vstride;
  gx += v * vstride;
  out += v * vstride;
  hprev += v * hstride;

  Acc<T> acc;
  acc.zero();
  const int kchunks = (C + BK - 1) / BK;
  const int n_iter = 9 * kchunks;
  uint4 ra[TL::AV], rb[TL::BV];
  fetch<T>(hprev, w, 0, kchunks, m0, n0, H, W, C, ra, rb);
  for (int it = 0; it < n_iter; ++it) {
    stash<T>(As, Bs, ra, rb);
    __syncthreads();
    if (it + 1 < n_iter)
      fetch<T>(hprev, w, it + 1, kchunks, m0, n0, H, W, C, ra, rb);
    acc.run(As, Bs);
    __syncthreads();
  }
  acc.store(Cs);
  __syncthreads();

  // Epilogue: gate, lerp, store h_s, 8 channels per step.
  for (int i = threadIdx.x; i < BM * BN / 8; i += NT) {
    const int r = i / (BN / 8), nv = (i % (BN / 8)) * 8;
    const int p = m0 + r, n = n0 + nv;
    if (p >= M || n >= C) continue;
    const long long off = static_cast<long long>(p) * C + n;
    float xv[8], gv[8], hv[8], o[8];
    load8<T>(x + off, xv);
    load8<T>(gx + off, gv);
    load8<T>(hprev + off, hv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float g = 1.0f / (1.0f + expf(-(Cs[r * TL::LDC + nv + e] + gv[e])));
      o[e] = g * xv[e] + (1.0f - g) * hv[e];
    }
    store8<T>(out + off, o);
  }
}

template <typename T>
int launch(const void* x, const void* gx, const void* hprev, const void* w,
           void* out, long long vstride, long long hstride, int V, int H,
           int W, int C, void* stream) {
  const dim3 grid((H * W + BM - 1) / BM, (C + BN - 1) / BN, V);
  twa_step_kernel<T><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(gx),
      static_cast<const T*>(hprev), static_cast<const T*>(w),
      static_cast<T*>(out), vstride, hstride, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() right after the launch (0 on success).
int twa_step_bf16(const void* x, const void* gx, const void* hprev,
                  const void* w, void* out, long long vstride,
                  long long hstride, int V, int H, int W, int C,
                  void* stream) {
  return launch<__nv_bfloat16>(x, gx, hprev, w, out, vstride, hstride, V, H,
                               W, C, stream);
}

int twa_step_f32(const void* x, const void* gx, const void* hprev,
                 const void* w, void* out, long long vstride,
                 long long hstride, int V, int H, int W, int C,
                 void* stream) {
  return launch<float>(x, gx, hprev, w, out, vstride, hstride, V, H, W, C,
                       stream);
}

const char* twa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
