// The eval-mode inverted-residual dwBlock in one pass on Hopper (sm_90a),
// CUDA C++.
//
// Replaces iip_uavsal_saliency_tpu/ops/pallas_dwblock.py::fused_dwblock_pallas
// (the Pallas TPU kernel). With BatchNorm folded into the weights it computes
//
//     e = relu6(x . W1 + b1)            1x1 expand,  C  -> E   (rounded to T)
//     d = relu6(dw3x3_same(e) + bd)     depthwise,   E  -> E   (rounded to T)
//     p = d . W2 + b2 (+ x)             1x1 project, E  -> Co  (stored as T)
//
// over x (N, H, W, C) in NHWC order, W1 (C, E), Wd (3, 3, E), W2 (E, Co),
// products accumulated in f32, with the rounding points of `dwblock_ref`.
// The expanded maps e and d never reach device memory.
//
// What bounds it on an H100: at the flagship 20x45x80, C = Co = 256,
// E = 1536 one call is 2*72000*(256*1536 + 9*1536 + 1536*256) = 115 GFLOP
// against 75 MB of x, out and weights, so it is bound by operations (about
// 117 us at the 989 TFLOP/s bf16 peak against 22 us for the bytes at
// 3.35 TB/s). Run as three library convs the same block moves the two
// 221 MB expanded maps through device memory several times; keeping them
// in shared memory is the point of the kernel.
//
// Design. One block of 512 threads per tile of TH x TW output pixels of one
// frame (and per 256 output channels). The block stages the tile's x with a
// 1-pixel halo in shared memory once, then walks E in chunks of EC. All
// staging is cp.async: the next slice of W1 (into the next chunk) lands in
// a second buffer while the current one is multiplied and while the
// depthwise and project phases run; a chunk's W2 rows, biases and taps land
// during its expand GEMM.
//   A. expand: e[halo pixels, EC] = xs . W1[:, chunk], the K dimension in
//      slices of 128, 64 or 32 rows of W1 (the most that fit) staged in
//      shared memory; + b1, ReLU6, rounded to T into shared memory. A halo
//      pixel outside the image is written as ZERO, not relu6(b1): the
//      depthwise conv pads the expanded map. Halo pixels inside the image
//      are real and recomputed per tile.
//   B. depthwise: 9 taps in f32 from the staged e, + bd, ReLU6, rounded to
//      T into shared memory.
//   C. project: p[tile pixels, Co] += d . W2[chunk, :], accumulated in f32
//      registers across all chunks.
// The epilogue adds b2 and, for a residual block, x from the staged tile,
// and stores T. bf16 runs both GEMMs on the tensor cores (mma.sync
// m16n8k16, f32 accumulate, operands through ldmatrix, which also turns the
// row-major W1 and W2 tiles into B operands); f32 runs plain FMA (no TF32)
// on a smaller tile, so the f32 check is tight enough to show an indexing
// error. Ragged H, W, C, E and Co are handled by zero fill while staging
// and by masks in the epilogue. The three phases of a chunk run one after
// the other behind block-wide barriers, both GEMMs are bound by ldmatrix's
// shared-memory reads, and every block re-reads all of W1 and W2 from L2:
// wgmma, TMA (with multicast across a cluster) and overlapping the phases
// are later work.
//
// Requirements (checked by the Python wrapper): C, E, Co multiples of 8,
// all pointers 16-byte aligned, contiguous tensors, and a staged tile that
// fits the 227 KB of shared memory (`Lay::smem_bytes`): C <= MAX_C.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NT = 512;            // threads per block
constexpr int NWARP = NT / 32;     // 16 warps
constexpr int NP = 256;            // output channels per block
constexpr int SMEM_LIMIT = 232448; // 227 KB, the most a Hopper block can use
constexpr int MAX_C = 352;         // widest x that fits; ops/dwblock.py gates on it

// Timing-only builds (tools/k2_probe.py) compile parts of the kernel out with
// -DDWBLOCK_SKIP=<bit mask over Part>; their results are wrong by design.
#ifndef DWBLOCK_SKIP
#define DWBLOCK_SKIP 0
#endif
enum Part { W1_COPIES, EXPAND, EXPAND_EPILOGUE, DEPTHWISE, PROJECT, W2_COPIES };
__host__ __device__ constexpr bool runs(Part p) { return !((DWBLOCK_SKIP >> p) & 1); }

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int TH = 8, TW = 16, EC = 64;
};
template <>
struct Cfg<float> {
  static constexpr int TH = 4, TW = 16, EC = 32;
};

// Shared-memory layout. Row strides carry VEC elements of padding, which
// keeps rows 16-byte aligned and ldmatrix's eight rows off a common bank.
template <typename T>
struct Lay {
  static constexpr int TH = Cfg<T>::TH, TW = Cfg<T>::TW;
  static constexpr int EC = Cfg<T>::EC;
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int HW2 = TW + 2;              // halo tile width
  static constexpr int HP = (TH + 2) * HW2;       // halo pixels
  static constexpr int MP = round_up(HP, 16);     // rows of the expand GEMM
  static constexpr int TP = TH * TW;              // output pixels
  static constexpr int LDE = EC + VEC;            // e, d, W1 slice rows
  static constexpr int LDW2 = NP + VEC;
  static constexpr int ES_BYTES = round_up(MP * LDE * sizeof(T), 128);
  static constexpr int DS_BYTES = round_up(TP * LDE * sizeof(T), 128);
  static constexpr int W2_BYTES = round_up(EC * LDW2 * sizeof(T), 128);
  static constexpr int VEC_BYTES = round_up(11 * EC * sizeof(T), 128);
  __host__ __device__ static constexpr int ldx(int C) {
    return round_up(C, 16) + VEC;
  }
  __host__ __device__ static constexpr int xs_bytes(int C) {
    return round_up(MP * ldx(C) * static_cast<int>(sizeof(T)), 128);
  }
  __host__ __device__ static constexpr int fixed_bytes(int C) {
    return xs_bytes(C) + ES_BYTES + DS_BYTES + W2_BYTES + VEC_BYTES;
  }
  // Rows of W1 in one staged slice: the most of 128, 64, 32 whose two
  // buffers fit beside the rest. Every slice costs the block a barrier and
  // a refill of its tensor-core pipeline, so longer slices are faster.
  __host__ __device__ static constexpr int w1_bytes(int ks) {
    return round_up(ks * LDE * static_cast<int>(sizeof(T)), 128);
  }
  __host__ __device__ static constexpr int ks(int C) {
    int k = 128;
    while (k > 32 && fixed_bytes(C) + 2 * w1_bytes(k) > SMEM_LIMIT) k /= 2;
    return k;
  }
  __host__ __device__ static constexpr int smem_bytes(int C) {
    return fixed_bytes(C) + 2 * w1_bytes(ks(C));
  }
};

static_assert(Lay<__nv_bfloat16>::smem_bytes(MAX_C) <= SMEM_LIMIT &&
                  Lay<float>::smem_bytes(MAX_C) <= SMEM_LIMIT &&
                  Lay<float>::smem_bytes(MAX_C + 8) > SMEM_LIMIT,
              "MAX_C is the widest x tile that fits shared memory");

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

__device__ __forceinline__ float relu6(float v) {
  return fminf(fmaxf(v, 0.0f), 6.0f);
}

// N consecutive elements as f32, moved in 16-byte words where N elements
// fill them (the address is then 16-byte aligned) and in 4-byte words else.
template <typename T, int N>
struct Run {
  static constexpr int BYTES = N * sizeof(T);
  static_assert(BYTES % 4 == 0, "a run is whole 4-byte words");
  static constexpr bool WIDE = BYTES % 16 == 0;
  static constexpr int WORD = WIDE ? 16 : 4;
  static constexpr int PER = WORD / sizeof(T);  // elements per word
};

template <typename T, int N>
__device__ __forceinline__ void load_run(const T* p, float (&out)[N]) {
  using R = Run<T, N>;
#pragma unroll
  for (int q = 0; q < N / R::PER; ++q) {
    uint4 u;
    if (R::WIDE)
      u = *reinterpret_cast<const uint4*>(p + q * R::PER);
    else
      u.x = *reinterpret_cast<const unsigned*>(p + q * R::PER);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < R::PER; ++e) out[q * R::PER + e] = to_f(t[e]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_run(T* p, const float (&in)[N]) {
  using R = Run<T, N>;
#pragma unroll
  for (int q = 0; q < N / R::PER; ++q) {
    uint4 u;
    T* t = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int e = 0; e < R::PER; ++e) t[e] = from_f<T>(in[q * R::PER + e]);
    if (R::WIDE)
      *reinterpret_cast<uint4*>(p + q * R::PER) = u;
    else
      *reinterpret_cast<unsigned*>(p + q * R::PER) = u.x;
  }
}

// 16-byte asynchronous copy from device to shared memory; `valid` false
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Tensor-core primitives (PTX). `ldsm` loads four 8x8 b16 matrices from
// shared memory: lane l gives the address of row l % 8 of matrix l / 8, and
// receives, of matrix i, the two elements (row l / 4, columns 2 * (l % 4)
// and + 1) in r[i]; `.trans` hands out the transposed matrices instead,
// which is how a row-major (k, n) tile becomes the mma's B operand.
__device__ __forceinline__ void ldsm(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// c (16x8, f32) += a (16x16, bf16, row-major) . b (16x8, bf16). With
// g = l / 4, t = l % 4: c[0], c[1] are (row g, columns 2t, 2t + 1) and
// c[2], c[3] the same columns of row g + 8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The two GEMMs of a block, per element type. `each_e` / `each_p` hand the
// accumulators to f(row, col, v) in runs of consecutive columns (2 in bf16,
// the pair a thread holds of an mma tile; 8 in f32).
template <typename T>
struct Mma;

// bf16 on the tensor cores (mma.sync m16n8k16, operands through ldmatrix).
// Expand: warp w owns the 48 rows of block w / EN and the 16 columns of
// block w % EN. Project: warp w owns the 32 rows of block w % PMB and the
// 64 columns of block w / PMB.
template <>
struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  using L = Lay<T>;
  static constexpr int EN = L::EC / 16;             // column blocks, expand
  static constexpr int EMB = NWARP / EN;            // row blocks, expand
  static constexpr int EI = L::MP / 16 / EMB;       // 16-row tiles per warp
  static constexpr int PMB = L::TP / 32;            // row blocks, project
  static constexpr int PJ = NP / (NWARP / PMB) / 16;  // 16-column groups per warp
  static_assert(NWARP % EN == 0 && EMB * EI * 16 == L::MP, "expand tiling");
  static_assert(NWARP % PMB == 0 && (NWARP / PMB) * PJ * 16 == NP, "project tiling");
  float acc_e[EI][2][4];
  float acc_p[2][2 * PJ][4];

  __device__ void zero_e() {
#pragma unroll
    for (int i = 0; i < EI; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc_e[i][j][q] = 0.0f;
  }
  __device__ void zero_p() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2 * PJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc_p[i][j][q] = 0.0f;
  }

  // One K slice of the expand GEMM: rows k0 .. k0 + kn of W1 (kn a multiple
  // of 16, zero past C) are staged in w1s.
  __device__ void expand(const T* xs, int ldx, int k0, int kn, const T* w1s) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int lrow = lane % 16, lcol = (lane / 16) * 8;
    const int r0 = (warp / EN) * EI * 16, n0 = (warp % EN) * 16;
#pragma unroll 2
    for (int kk = 0; kk < kn; kk += 16) {
      unsigned b[4];
      ldsm_trans(b, w1s + (kk + lrow) * L::LDE + n0 + lcol);
#pragma unroll
      for (int i = 0; i < EI; ++i) {
        unsigned a[4];
        ldsm(a, xs + (r0 + i * 16 + lrow) * ldx + k0 + kk + lcol);
        mma_bf16(acc_e[i][0], a, b[0], b[1]);
        mma_bf16(acc_e[i][1], a, b[2], b[3]);
      }
    }
  }

  template <typename F>
  __device__ void each_e(F f) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = (warp / EN) * EI * 16 + lane / 4;
    const int n0 = (warp % EN) * 16 + (lane % 4) * 2;
#pragma unroll
    for (int i = 0; i < EI; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float lo[2] = {acc_e[i][j][0], acc_e[i][j][1]};
        const float hi[2] = {acc_e[i][j][2], acc_e[i][j][3]};
        f(r0 + i * 16, n0 + j * 8, lo);
        f(r0 + i * 16 + 8, n0 + j * 8, hi);
      }
  }

  __device__ void project(const T* ds, const T* w2s, int ncol) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int lrow = lane % 16, lcol = (lane / 16) * 8;
    const int r0 = (warp % PMB) * 32, n0 = (warp / PMB) * PJ * 16;
#pragma unroll
    for (int kk = 0; kk < L::EC; kk += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm(a[i], ds + (r0 + i * 16 + lrow) * L::LDE + kk + lcol);
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        if (n0 + j * 16 >= ncol) continue;  // no such output channels
        unsigned b[4];
        ldsm_trans(b, w2s + (kk + lrow) * L::LDW2 + n0 + j * 16 + lcol);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc_p[i][2 * j], a[i], b[0], b[1]);
          mma_bf16(acc_p[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  template <typename F>
  __device__ void each_p(int ncol, F f) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = (warp % PMB) * 32 + lane / 4;
    const int n0 = (warp / PMB) * PJ * 16 + (lane % 4) * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2 * PJ; ++j) {
        if (n0 + j * 8 >= ncol) continue;
        const float lo[2] = {acc_p[i][j][0], acc_p[i][j][1]};
        const float hi[2] = {acc_p[i][j][2], acc_p[i][j][3]};
        f(r0 + i * 16, n0 + j * 8, lo);
        f(r0 + i * 16 + 8, n0 + j * 8, hi);
      }
  }
};

// f32 on plain FMA. Expand: thread t < MP * EC / 8 owns row t / (EC/8) and
// 8 columns. Project: thread t owns 8 columns (t % 32) and PI rows.
template <>
struct Mma<float> {
  using T = float;
  using L = Lay<T>;
  static constexpr int EG = L::EC / 8;          // column groups of the expand
  static constexpr int PG = NP / 8;             // column groups of the project
  static constexpr int PI = L::TP * PG / NT;    // rows per thread
  static_assert(L::MP * EG <= NT, "expand tiling");
  static_assert(L::TP * PG % NT == 0 && NT % PG == 0, "project tiling");
  float acc_e[8];
  float acc_p[PI][8];

  __device__ void zero_e() {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_e[e] = 0.0f;
  }
  __device__ void zero_p() {
#pragma unroll
    for (int i = 0; i < PI; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc_p[i][e] = 0.0f;
  }

  __device__ void expand(const T* xs, int ldx, int k0, int kn, const T* w1s) {
    if (threadIdx.x >= L::MP * EG) return;
    const int row = threadIdx.x / EG, col = (threadIdx.x % EG) * 8;
    for (int k = 0; k < kn; ++k) {
      const float a = xs[row * ldx + k0 + k];
      float b[8];
      load_run<T, 8>(w1s + k * L::LDE + col, b);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc_e[e] = fmaf(a, b[e], acc_e[e]);
    }
  }

  template <typename F>
  __device__ void each_e(F f) {
    if (threadIdx.x >= L::MP * EG) return;
    f(threadIdx.x / EG, (threadIdx.x % EG) * 8, acc_e);
  }

  __device__ void project(const T* ds, const T* w2s, int ncol) {
    const int col = (threadIdx.x % PG) * 8, r0 = threadIdx.x / PG;
    if (col >= ncol) return;
#pragma unroll 4
    for (int k = 0; k < L::EC; ++k) {
      float b[8];
      load_run<T, 8>(w2s + k * L::LDW2 + col, b);
#pragma unroll
      for (int i = 0; i < PI; ++i) {
        const float a = ds[(r0 + (NT / PG) * i) * L::LDE + k];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc_p[i][e] = fmaf(a, b[e], acc_p[i][e]);
      }
    }
  }

  template <typename F>
  __device__ void each_p(int ncol, F f) {
    const int col = (threadIdx.x % PG) * 8, r0 = threadIdx.x / PG;
    if (col >= ncol) return;
#pragma unroll
    for (int i = 0; i < PI; ++i) f(r0 + (NT / PG) * i, col, acc_p[i]);
  }
};

// grid = (N * tiles_y * tiles_x, ceil(Co / NP)).
template <typename T>
__global__ void __launch_bounds__(NT, 1)
    dwblock_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                   const T* __restrict__ b1, const T* __restrict__ wd,
                   const T* __restrict__ bd, const T* __restrict__ w2,
                   const T* __restrict__ b2, T* __restrict__ out, int H, int W,
                   int C, int E, int Co, int tiles_x, int tiles_y, int ks,
                   int residual) {
  using L = Lay<T>;
  constexpr int VEC = L::VEC;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = L::ldx(C);
  const int cpad = round_up(C, 16);
  unsigned char* sp = smem;
  T* xs = reinterpret_cast<T*>(sp);
  sp += L::xs_bytes(C);
  T* es = reinterpret_cast<T*>(sp);
  sp += L::ES_BYTES;
  T* ds = reinterpret_cast<T*>(sp);
  sp += L::DS_BYTES;
  T* w2s = reinterpret_cast<T*>(sp);
  sp += L::W2_BYTES;
  T* b1s = reinterpret_cast<T*>(sp);
  T* bds = b1s + L::EC;
  T* wds = bds + L::EC;  // [9][EC]
  sp += L::VEC_BYTES;
  T* w1s = reinterpret_cast<T*>(sp);  // two buffers of one slice of W1 each

  const int tid = threadIdx.x;
  const int tiles = tiles_x * tiles_y;
  const int tile = blockIdx.x % tiles;
  const long long n = blockIdx.x / tiles;
  const int ty0 = (tile / tiles_x) * L::TH, tx0 = (tile % tiles_x) * L::TW;
  const int co0 = blockIdx.y * NP;
  const int ncol = Co - co0 < NP ? Co - co0 : NP;
  const int ncol16 = round_up(ncol, 16);
  x += n * H * W * C;
  out += n * H * W * Co;

  // Every staging copy is a 16-byte cp.async, zero-filled where the source
  // does not exist (outside the image, past C, E or Co).
  auto stage_x = [&]() {
    const int groups = cpad / VEC;
    for (int i = tid; i < L::MP * groups; i += NT) {
      const int hp = i / groups, c = (i % groups) * VEC;
      const int gy = ty0 + hp / L::HW2 - 1, gx = tx0 + hp % L::HW2 - 1;
      const bool ok = hp < L::HP && c < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(xs + hp * ldx + c,
                 ok ? x + (static_cast<long long>(gy) * W + gx) * C + c : x, ok);
    }
  };
  // The chunk's rows of W2, and its b1, bd and nine rows of depthwise taps.
  auto stage_chunk = [&](int e0) {
    const int groups = ncol16 / VEC;
    for (int i = tid; i < L::EC * groups; i += NT) {
      const int r = i / groups, c = (i % groups) * VEC;
      const bool ok = e0 + r < E && c < ncol;
      cp_async16(w2s + r * L::LDW2 + c,
                 ok ? w2 + static_cast<long long>(e0 + r) * Co + co0 + c : w2, ok);
    }
    constexpr int vgroups = L::EC / VEC;
    for (int i = tid; i < 11 * vgroups; i += NT) {
      const int r = i / vgroups, c = (i % vgroups) * VEC;
      const T* row = r == 0 ? b1 : r == 1 ? bd : wd + static_cast<long long>(r - 2) * E;
      const bool ok = e0 + c < E;
      cp_async16(b1s + r * L::EC + c, ok ? row + e0 + c : row, ok);
    }
  };
  // Slice q of the flat (chunk, K slice) sequence of W1, into buffer q % 2;
  // nothing past the last slice.
  const int nslices = (cpad + ks - 1) / ks;
  const int nchunks = (E + L::EC - 1) / L::EC;
  const int w1_elems = L::w1_bytes(ks) / static_cast<int>(sizeof(T));
  auto stage_w1 = [&](int q) {
    if (q >= nchunks * nslices) return;
    const int e0 = (q / nslices) * L::EC, k0 = (q % nslices) * ks;
    T* dst = w1s + (q % 2) * w1_elems;
    constexpr int groups = L::EC / VEC;
    const int rows = cpad - k0 < ks ? cpad - k0 : ks;
    for (int i = tid; i < rows * groups; i += NT) {
      const int k = i / groups, c = (i % groups) * VEC;
      const bool ok = k0 + k < C && e0 + c < E;
      cp_async16(dst + k * L::LDE + c,
                 ok ? w1 + static_cast<long long>(k0 + k) * E + e0 + c : w1, ok);
    }
  };

  Mma<T> mma;
  mma.zero_p();
  stage_x();
  stage_chunk(0);
  stage_w1(0);
  cp_async_commit();
  int q = 0;
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    // A. expand GEMM over K slices of W1. Slice q + 1 (the next chunk's
    // first, after this chunk's last) lands while slice q is multiplied;
    // the first iteration also starts this chunk's W2 rows, biases and
    // taps, which the previous chunk was still reading until now.
    mma.zero_e();
    for (int s = 0; s < nslices; ++s, ++q) {
      cp_async_wait_all();
      __syncthreads();  // slice q is there, and slice q - 1's buffer is free
      if constexpr (runs(W2_COPIES))
        if (s == 0 && chunk > 0) stage_chunk(chunk * L::EC);
      if constexpr (runs(W1_COPIES)) stage_w1(q + 1);
      cp_async_commit();
      const int k0 = s * ks;
      if constexpr (runs(EXPAND))
        mma.expand(xs, ldx, k0, cpad - k0 < ks ? cpad - k0 : ks, w1s + (q % 2) * w1_elems);
    }
    if (nslices == 1) {  // then nothing above waited for the chunk's own copies
      cp_async_wait_all();
      __syncthreads();
    }
    if constexpr (runs(EXPAND_EPILOGUE))
    mma.each_e([&](int hp, int col, const auto& v) {
      constexpr int RUN = sizeof(v) / sizeof(float);
      const int gy = ty0 + hp / L::HW2 - 1, gx = tx0 + hp % L::HW2 - 1;
      const bool inside =
          hp < L::HP && gy >= 0 && gy < H && gx >= 0 && gx < W;
      float o[RUN];
#pragma unroll
      for (int e = 0; e < RUN; ++e)
        o[e] = inside ? relu6(v[e] + to_f(b1s[col + e])) : 0.0f;
      store_run<T, RUN>(es + hp * L::LDE + col, o);
    });
    __syncthreads();

    // B. depthwise 3x3 over the staged e: a warp per output column, a lane
    // per CPL channels; each staged e is read once and feeds the (up to)
    // three output rows it touches, taps in dy, dx order.
    if constexpr (runs(DEPTHWISE)) {
      constexpr int CPL = L::EC / 32;
      static_assert(L::TW == NWARP && L::EC % 32 == 0, "depthwise tiling");
      const int ox = tid / 32, c = (tid % 32) * CPL;
      float wt[9][CPL], acc[L::TH][CPL];
#pragma unroll
      for (int t = 0; t < 9; ++t) load_run<T, CPL>(wds + t * L::EC + c, wt[t]);
#pragma unroll
      for (int oy = 0; oy < L::TH; ++oy)
#pragma unroll
        for (int e = 0; e < CPL; ++e) acc[oy][e] = 0.0f;
#pragma unroll
      for (int r = 0; r < L::TH + 2; ++r)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float ev[CPL];
          load_run<T, CPL>(es + (r * L::HW2 + ox + dx) * L::LDE + c, ev);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int oy = r - dy;
            if (oy < 0 || oy >= L::TH) continue;
#pragma unroll
            for (int e = 0; e < CPL; ++e)
              acc[oy][e] = fmaf(ev[e], wt[dy * 3 + dx][e], acc[oy][e]);
          }
        }
      float bias[CPL];
      load_run<T, CPL>(bds + c, bias);
#pragma unroll
      for (int oy = 0; oy < L::TH; ++oy) {
#pragma unroll
        for (int e = 0; e < CPL; ++e) acc[oy][e] = relu6(acc[oy][e] + bias[e]);
        store_run<T, CPL>(ds + (oy * L::TW + ox) * L::LDE + c, acc[oy]);
      }
    }
    __syncthreads();

    // C. partial project GEMM.
    if constexpr (runs(PROJECT)) mma.project(ds, w2s, ncol);
    __syncthreads();
  }

  // Epilogue: + b2 (+ x), store the pixels and channels that exist.
  mma.each_p(ncol, [&](int p, int col, const auto& v) {
    constexpr int RUN = sizeof(v) / sizeof(float);
    const int oy = p / L::TW, ox = p % L::TW;
    const int gy = ty0 + oy, gx = tx0 + ox;
    if (col >= ncol || gy >= H || gx >= W) return;
    float o[RUN], bv[RUN];
    load_run<T, RUN>(b2 + co0 + col, bv);
#pragma unroll
    for (int e = 0; e < RUN; ++e) o[e] = v[e] + bv[e];
    if (residual) {
      float xv[RUN];
      load_run<T, RUN>(xs + ((oy + 1) * L::HW2 + ox + 1) * ldx + co0 + col, xv);
#pragma unroll
      for (int e = 0; e < RUN; ++e) o[e] += xv[e];
    }
    store_run<T, RUN>(out + (static_cast<long long>(gy) * W + gx) * Co + co0 + col, o);
  });
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* wd,
           const void* bd, const void* w2, const void* b2, void* out, int N,
           int H, int W, int C, int E, int Co, int residual, void* stream) {
  using L = Lay<T>;
  const int smem = L::smem_bytes(C);
  if (smem > SMEM_LIMIT || (residual && C != Co))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaFuncSetAttribute(
      dwblock_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int tiles_x = (W + L::TW - 1) / L::TW, tiles_y = (H + L::TH - 1) / L::TH;
  const long long blocks = static_cast<long long>(N) * tiles_x * tiles_y;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), (Co + NP - 1) / NP);
  dwblock_kernel<T><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(wd),
      static_cast<const T*>(bd), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), H, W, C, E, Co, tiles_x,
      tiles_y, L::ks(C), residual);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() right after the launch (0 on success).
int dwblock_bf16(const void* x, const void* w1, const void* b1, const void* wd,
                 const void* bd, const void* w2, const void* b2, void* out,
                 int N, int H, int W, int C, int E, int Co, int residual,
                 void* stream) {
  return launch<__nv_bfloat16>(x, w1, b1, wd, bd, w2, b2, out, N, H, W, C, E,
                               Co, residual, stream);
}

int dwblock_f32(const void* x, const void* w1, const void* b1, const void* wd,
                const void* bd, const void* w2, const void* b2, void* out,
                int N, int H, int W, int C, int E, int Co, int residual,
                void* stream) {
  return launch<float>(x, w1, b1, wd, bd, w2, b2, out, N, H, W, C, E, Co,
                       residual, stream);
}

const char* dwblock_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
