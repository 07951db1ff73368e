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
// over x (N, H, W, C) in NHWC order, products accumulated in f32, with the
// rounding points of `dwblock_ref`. The expanded maps e and d never reach
// device memory.
//
// What bounds it on an H100: at the flagship 20x45x80, C = Co = 256,
// E = 1536 one call is 2*72000*(256*1536 + 9*1536 + 1536*256) = 115 GFLOP
// against 75 MB of x, out and weights, so it is bound by operations (about
// 117 us at the 989 TFLOP/s bf16 peak against 22 us for the bytes at
// 3.35 TB/s). Run as three library convs the same block moves the two
// 221 MB expanded maps through device memory several times; keeping them
// in shared memory is the point of the kernel.
//
// Design (bf16). One block of 512 threads (four warpgroups) per tile of 8 x 16
// output pixels of one frame and per 256 output channels. The block stages
// the tile's x with a 1-pixel halo (10 x 18 = 180 pixels, 192 GEMM rows) in
// shared memory once, then walks E in chunks of 64:
//   A. expand: e[192, 64] = xs . W1[:, chunk] on wgmma, warpgroups 0-2 one
//      m64n64k16 row block each over K = round_up(C, 16); + b1, ReLU6,
//      rounded to T into shared memory. A halo pixel outside the image is
//      written as ZERO, not relu6(b1): the depthwise conv pads e. Halo
//      pixels inside the image are real and recomputed per tile.
//   B. depthwise: 9 taps in f32 from the staged e, + bd, ReLU6, rounded to
//      T into shared memory.
//   C. project: p[128, 256] += d . W2[chunk, :] on wgmma, each warpgroup one
//      m64n128k16 quarter, accumulated in registers across all chunks.
// The epilogue adds b2 and, for a residual block, x from the staged tile,
// and stores T.
//
// bf16 layout. Both GEMMs read A and B from shared memory by descriptor, in
// wgmma's K-major layout without swizzle: core matrices of 8 rows x 16 bytes
// (8 channels) stored as "planes" [K / 8][rows][8]. x is staged into such
// planes with one 16-byte cp.async per pixel and plane, and the depthwise
// phase writes d into them; each plane of x and d is padded by 16 bytes,
// which puts the 16-byte pieces of consecutive planes (cp.async writes) and
// the per-pixel reads of the depthwise stores and the residual on distinct
// banks. The weights are constants: `ops/dwblock.py::pack_dwblock_weights`
// lays them out once, at load, in the byte order the kernel wants in shared
// memory (W1 as [chunk][C/8 planes][64][8]; per chunk and 256-column block
// W2 as [8 planes][Co rows][8], followed by the chunk's b1, bd and nine rows
// of taps), so each piece arrives by one bulk copy (cp.async.bulk, the TMA
// unit without a tensor map) issued by one thread and completed on an
// mbarrier: W1 in slices of 64 rows through a ring of as many 8 KB buffers
// as shared memory holds (2 at C = 352, 6 at C = 256, at most 8), the
// next chunk's first slices landing while this chunk's epilogue, depthwise
// and project run; a chunk's W2 piece after the previous chunk's project,
// during this chunk's expand. Zero padding (K to 16, the last ragged E
// chunk) is the pack's, so the kernel has no masks on C or E. The three
// phases of a chunk still run one after the other behind block barriers,
// and every block still reads all of W1 and W2 from L2: TMA multicast over
// a cluster, warp-specialised overlap of the phases and a narrow variant
// for small Co are later work.
//
// f32 runs both GEMMs on the tensor cores as 3xTF32: each f32 operand v is
// split into a TF32 part big = rna(v) and a TF32 residual small =
// rna(v - big), |v - big - small| <= 2^-22 |v|, and a product is
// accumulated in f32 as small.big + big.small + big.big (the dropped
// small.small term is about 2^-22 of it). At the flagship block that is
// 3 x 113 GFLOP at the 495 TFLOP/s TF32 peak plus the depthwise's 2 GFLOP at
// the 67 TFLOP/s FMA peak: about 720 us, against 1719.95 us for the whole
// block on plain FMA. Same tile, warpgroups and chunk loop as bf16, with
// what f32 changes:
//   - x (192 x C x 4 bytes) no longer fits beside the rest, so it is not
//     staged whole: slices of 8 channels of the tile's 180 halo pixels ride
//     through the ring beside the matching 8 rows of W1 (one k8 step per
//     slot), and each E chunk reads x's tile again, from L2. Warpgroup 3,
//     idle during the expand, loads them: 16-byte cp.async per pixel half
//     (zeros outside the image), completing on the slot's mbarrier with
//     `cp.async.mbarrier.arrive.noinc`; W1's slice comes by one bulk copy.
//     (One warp alone issues them too slowly to keep the ring full.)
//     C is then bounded by the bf16 layout alone.
//   - A (x for the expand, d for the project) is read from shared memory
//     in f32 and split in registers; wgmma takes it from registers. B (W1,
//     W2) is split at load by `ops/dwblock.py::pack_dwblock_weights`,
//     big and small planes side by side (planes of 4 channels, k8 steps).
//     Within each k8 step the pack orders the 8 rows as channels
//     0 2 4 6 | 1 3 5 7, so that a thread's two A values of a row (MMA k = t
//     and t + 4) are channels 2t and 2t + 1: one 8-byte load.
//   - E chunks of 64 with the chunk's W2 piece resident (128 KB for big and
//     small at 256 columns); d is written over e once the depthwise has
//     read it (in registers), which leaves room for a ring of 4 slices.
//   - The project's width per warpgroup follows Co (16, 32, 64 or 128
//     columns, a template), so a narrow block does not pay for 256.
//   - The residual reads x from device memory.
//   - The tensor cores' f32 sums are not IEEE round-to-nearest: their
//     error grows with the length of the sum, and with all of K in one
//     accumulator the flagship block fell outside the f32 check. So the
//     tensor cores sum at most K = 128 of the expand (16 slices) and K = 64
//     of the project (one chunk) into a partial that is then added in f32:
//     to e in shared memory for the expand, to the project's register
//     accumulator for the project.
//   - A register operand may not be rewritten while a wgmma that reads it
//     is in flight: the expand waits for each slice's wgmma group before
//     loading the next slice's A. (Two register sets, one group in
//     flight, read slower on an H100: the registers are short.)
// The f32 check (2e-5 on outputs of order 1 to 8) still shows an indexing
// error: a slip of one TF32 rounding is 2^-11.
//
// Requirements (checked by the Python wrapper): C, E, Co multiples of 8,
// all pointers 16-byte aligned, contiguous tensors, and (for the bf16
// kernel's staged x tile) C <= MAX_C, the same gate for both dtypes.

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"
#include "smem.cuh"

namespace {

constexpr int NT = 512;            // threads per block
constexpr int NWARP = NT / 32;     // 16 warps
constexpr int NP = 256;            // output channels per block
constexpr int SMEM_LIMIT = 232448; // 227 KB, the most a Hopper block can use
constexpr int MAX_C = 352;         // widest x the bf16 tile takes; ops/dwblock.py gates on it

// Timing-only builds (tools/k2_probe.py) compile parts of either kernel
// out with -DDWBLOCK_SKIP=<bit mask over Part>; their results are wrong by
// design.
#ifndef DWBLOCK_SKIP
#define DWBLOCK_SKIP 0
#endif
enum Part { COPIES, EXPAND, EXPAND_EPILOGUE, DEPTHWISE, PROJECT };
__host__ __device__ constexpr bool runs(Part p) { return !((DWBLOCK_SKIP >> p) & 1); }

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// The bf16 kernel's shared memory (bytes unless named *_ELEMS or a stride in
// elements), in this order: mbarriers, the W1 ring, the W2 piece, e, d, x.
struct BLay {
  static constexpr int TH = 8, TW = 16, EC = 64;
  static constexpr int PLANE = 8;                  // channels per core-matrix row
  static constexpr int KS = 64;                    // rows of W1 per bulk copy
  static constexpr int HW2 = TW + 2;               // halo tile width
  static constexpr int HP = (TH + 2) * HW2;        // halo pixels
  static constexpr int MP = 192;                   // rows of the expand GEMM: 3 x m64
  static constexpr int TP = TH * TW;               // output pixels: 2 x m64
  static constexpr int XPLANE = MP * PLANE + PLANE;  // elements of a plane of x, padded
  static constexpr int DPLANE = TP * PLANE + PLANE;  // elements of a plane of d, padded
  static constexpr int LDE = EC + PLANE;           // row of e (pixel-major, padded)
  static constexpr int SLICE_ELEMS = KS * EC;
  static constexpr int VEC_ELEMS = 11 * EC;        // b1, bd, nine rows of taps
  static constexpr int MAX_RING = 8;
  static constexpr int BAR_BYTES = 256;            // 2 * MAX_RING + 1 mbarriers
  static constexpr int RING_SLOT = SLICE_ELEMS * 2;
  static constexpr int W2_BYTES = (EC * NP + VEC_ELEMS) * 2;
  static constexpr int ES_BYTES = MP * LDE * 2;
  static constexpr int DS_BYTES = EC / PLANE * DPLANE * 2;
  __host__ __device__ static constexpr int xs_bytes(int C) {
    return round_up(C, 16) / PLANE * XPLANE * 2;
  }
  __host__ __device__ static constexpr int fixed_bytes(int C) {
    return BAR_BYTES + W2_BYTES + ES_BYTES + DS_BYTES + xs_bytes(C);
  }
  // Slots of the W1 ring: as many as fit, at most MAX_RING; the pipeline
  // needs two (a slot is refilled only once every expand warp is done with it).
  __host__ __device__ static constexpr int ring(int C) {
    return (SMEM_LIMIT - fixed_bytes(C)) / RING_SLOT < MAX_RING
               ? (SMEM_LIMIT - fixed_bytes(C)) / RING_SLOT
               : MAX_RING;
  }
  __host__ __device__ static constexpr int smem_bytes(int C) {
    return fixed_bytes(C) + ring(C) * RING_SLOT;
  }
};
static_assert(BLay::W2_BYTES % 128 == 0 && BLay::ES_BYTES % 128 == 0 &&
                  BLay::DS_BYTES % 128 == 0 && BLay::RING_SLOT % 128 == 0,
              "every buffer starts 128-byte aligned");
static_assert(BLay::MP >= BLay::HP && BLay::TW == NWARP, "tiling");

// The f32 kernel's shared memory (bytes unless named *_ELEMS), in this
// order: mbarriers, the W2 piece (big planes, small planes, then b1, bd and
// nine rows of taps), e (d is later written over it), and the ring, whose
// slot holds an x slice (pixel-major, 8 channels) and its W1 slice (big
// planes, small planes).
struct FLay {
  static constexpr int TH = 8, TW = 16, EC = 64;
  static constexpr int PLANE = 4;                   // f32 channels per core-matrix row
  static constexpr int CORE = 8 * 16;               // bytes of a core matrix: 8 rows of 16
  static constexpr int KS = 8;                      // channels of x per slice: one k8 step
  static constexpr int GROUP = 16;                  // expand k8 steps the tensor cores sum at a time
  static constexpr int HW2 = TW + 2;                // halo tile width
  static constexpr int HP = (TH + 2) * HW2;         // halo pixels
  static constexpr int TP = TH * TW;                // output pixels: 2 x m64
  static constexpr int LDE = EC + 8;                // row of e and d: 288 bytes, conflict-free
  static constexpr int VEC_ELEMS = 11 * EC;         // b1, bd, nine rows of taps
  static constexpr int MAX_RING = 12;
  static constexpr int BAR_BYTES = 256;             // 2 * MAX_RING + 1 mbarriers
  static constexpr int XS_BYTES = HP * KS * 4;
  static constexpr int W1S_ELEMS = 2 * KS * EC;     // big and small
  static constexpr int RING_SLOT = XS_BYTES + W1S_ELEMS * 4;
  static constexpr int ED_BYTES = HP * LDE * 4;
  // The W2 piece holds the columns of the widest column block,
  // wcols = min(Co, NP); the ring takes what is left, at most MAX_RING.
  __host__ __device__ static constexpr int w2_bytes(int wcols) {
    return round_up((2 * EC * wcols + VEC_ELEMS) * 4, 128);
  }
  __host__ __device__ static constexpr int fixed_bytes(int wcols) {
    return BAR_BYTES + w2_bytes(wcols) + ED_BYTES;
  }
  __host__ __device__ static constexpr int ring(int wcols) {
    return (SMEM_LIMIT - fixed_bytes(wcols)) / RING_SLOT < MAX_RING
               ? (SMEM_LIMIT - fixed_bytes(wcols)) / RING_SLOT
               : MAX_RING;
  }
  __host__ __device__ static constexpr int smem_bytes(int wcols) {
    return fixed_bytes(wcols) + ring(wcols) * RING_SLOT;
  }
};
static_assert(FLay::XS_BYTES % 128 == 0 && FLay::ED_BYTES % 128 == 0 &&
                  FLay::RING_SLOT % 128 == 0 && 8 * (2 * FLay::MAX_RING + 1) <= FLay::BAR_BYTES,
              "every f32 buffer starts 128-byte aligned");
static_assert(FLay::ring(NP) >= 2 && FLay::smem_bytes(NP) <= SMEM_LIMIT &&
                  FLay::TP <= FLay::HP && FLay::HP <= 3 * 64 && FLay::TW == NWARP,
              "f32 tiling");
// x is staged whole only by the bf16 kernel, whose ring then keeps two
// slots up to MAX_C and not one channel group more.
static_assert(BLay::smem_bytes(MAX_C) <= SMEM_LIMIT && BLay::ring(MAX_C) >= 2 &&
                  BLay::ring(MAX_C + 8) < 2,
              "MAX_C is the widest x tile that fits shared memory");

__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
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

// bf16 on wgmma. w1p and w2p are the packed weights of
// ops/dwblock.py::pack_dwblock_weights. grid = (N * tiles_y * tiles_x,
// ceil(Co / NP)).
__global__ void __launch_bounds__(NT, 1)
    dwblock_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w1p,
                        const __nv_bfloat16* __restrict__ w2p,
                        const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                        int H, int W, int C, int E, int Co, int tiles_x, int tiles_y,
                        int residual) {
  using T = __nv_bfloat16;
  using L = BLay;
  constexpr int PL = L::PLANE;
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = L::ring(C);
  const int planes = round_up(C, 16) / PL;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [R]: a W1 slice landed
  uint64_t* empty = full + L::MAX_RING;                // [R]: all expand warps read it
  uint64_t* w2full = empty + L::MAX_RING;              // the chunk's W2 piece landed
  unsigned char* sp = smem + L::BAR_BYTES;
  T* ring = reinterpret_cast<T*>(sp);
  sp += R * L::RING_SLOT;
  T* w2s = reinterpret_cast<T*>(sp);  // [8 planes][ncol][8], then b1, bd, taps
  sp += L::W2_BYTES;
  T* es = reinterpret_cast<T*>(sp);   // [MP][LDE]
  sp += L::ES_BYTES;
  T* ds = reinterpret_cast<T*>(sp);   // [8 planes][TP][8] + pad
  sp += L::DS_BYTES;
  T* xs = reinterpret_cast<T*>(sp);   // [planes][MP][8] + pad

  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32;
  const int tiles = tiles_x * tiles_y;
  const int tile = blockIdx.x % tiles;
  const long long n = blockIdx.x / tiles;
  const int ty0 = (tile / tiles_x) * L::TH, tx0 = (tile % tiles_x) * L::TW;
  const int co0 = blockIdx.y * NP;
  const int ncol = Co - co0 < NP ? Co - co0 : NP;  // rows of this block's W2 piece
  const T* b1s = w2s + L::EC * ncol;
  const T* bds = b1s + L::EC;
  const T* wds = bds + L::EC;  // [9][EC]
  x += n * H * W * C;
  out += n * H * W * Co;

  const int nchunks = (E + L::EC - 1) / L::EC;
  const int nslices = (planes * PL + L::KS - 1) / L::KS;
  const int total = nchunks * nslices;
  constexpr int PRODUCER = 3 * 128;  // the first thread of the warpgroup the expand leaves free

  // Slice q of the flat (chunk, K slice) sequence of W1, into slot q % R.
  auto issue_w1 = [&](int q) {
    const int chunk = q / nslices, p0 = (q % nslices) * (L::KS / PL);
    const int np = planes - p0 < L::KS / PL ? planes - p0 : L::KS / PL;
    uint64_t* bar = &full[q % R];
    if constexpr (runs(COPIES))
      bulk_load(ring + (q % R) * L::SLICE_ELEMS,
                w1p + (static_cast<long long>(chunk) * planes + p0) * L::EC * PL,
                np * L::EC * PL * 2, bar);
    else
      bar_arrive(bar);
  };
  // The chunk's W2 rows of this column block, then its b1, bd and taps.
  auto issue_w2 = [&](int chunk) {
    const long long at = static_cast<long long>(chunk) * (L::EC * Co + gridDim.y * L::VEC_ELEMS) +
                         blockIdx.y * (L::EC * NP + L::VEC_ELEMS);
    if constexpr (runs(COPIES))
      bulk_load(w2s, w2p + at, (L::EC * ncol + L::VEC_ELEMS) * 2, w2full);
    else
      bar_arrive(w2full);
  };

  if (tid == 0) {
    for (int i = 0; i < R; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], 12);  // the 12 warps of warpgroups 0-2
    }
    bar_init(w2full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == PRODUCER) {
    for (int q = 0; q < R && q < total; ++q) issue_w1(q);
    issue_w2(0);
  }
  // x with its halo, zero outside the image and past C: one 16-byte
  // cp.async per pixel and plane, consecutive threads on consecutive planes
  for (int i = tid; i < L::MP * planes; i += NT) {
    const int hp = i / planes, g = i % planes, c = g * PL;
    const int gy = ty0 + hp / L::HW2 - 1, gx = tx0 + hp % L::HW2 - 1;
    const bool ok = hp < L::HP && c < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp_async16(xs + g * L::XPLANE + hp * PL,
               ok ? x + (static_cast<long long>(gy) * W + gx) * C + c : x, ok);
  }
  cp_async_commit();
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();

  float acc_p[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_p[i] = 0.0f;
  const int prow = (wg % 2) * 64, pcol = (wg / 2) * 128;  // this warpgroup's quarter of p

  for (int chunk = 0, q = 0; chunk < nchunks; ++chunk, q += nslices) {
    // A. expand, warpgroup wg < 3 on halo rows 64 wg ..; slice q + s of W1
    // is waited for on its slot's `full`, and released on `empty` once the
    // wgmma group that read it has completed (one group stays in flight).
    if (wg < 3) {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      keep(acc);
      wgmma_fence();
      const uint64_t da = smem_desc(xs + wg * 64 * PL, L::XPLANE * 2, 16 * PL);
      for (int s = 0; s < nslices; ++s) {
        const int qq = q + s, p0 = s * (L::KS / PL);
        const int np = planes - p0 < L::KS / PL ? planes - p0 : L::KS / PL;
        bar_wait(&full[qq % R], (qq / R) & 1);
        __syncwarp();
        const uint64_t db = smem_desc(ring + (qq % R) * L::SLICE_ELEMS, L::EC * 16, 16 * PL);
        if constexpr (runs(EXPAND))
          for (int kk = 0; kk < np; kk += 2)  // 16 channels: two planes
            wgmma_bf16<64>(acc, da + (((p0 + kk) * L::XPLANE * 2) >> 4),
                           db + ((kk * L::EC * 16) >> 4));
        wgmma_commit();
        if (s > 0) {
          wgmma_wait<1>();
          if (lane == 0) bar_arrive(&empty[(qq - 1) % R]);
        }
      }
      wgmma_wait<0>();
      keep(acc);
      if (lane == 0) bar_arrive(&empty[(q + nslices - 1) % R]);
      bar_wait(w2full, chunk & 1);  // b1 rides with the chunk's W2 piece
      // + b1, ReLU6, zero outside the image, rounded to bf16 into e
      if constexpr (runs(EXPAND_EPILOGUE)) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * (lane % 4);
          const float bb[2] = {to_f(b1s[col]), to_f(b1s[col + 1])};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int hp = wg * 64 + 16 * warp + lane / 4 + 8 * h;
            const int gy = ty0 + hp / L::HW2 - 1, gx = tx0 + hp % L::HW2 - 1;
            const bool inside = hp < L::HP && gy >= 0 && gy < H && gx >= 0 && gx < W;
            const float o[2] = {inside ? relu6(acc[4 * j + 2 * h] + bb[0]) : 0.0f,
                                inside ? relu6(acc[4 * j + 2 * h + 1] + bb[1]) : 0.0f};
            store_run<T, 2>(es + hp * L::LDE + col, o);
          }
        }
      }
    } else if (tid == PRODUCER) {
      // refill each slot of this chunk with the slice R later, once read
      for (int s = 0; s < nslices && q + s + R < total; ++s) {
        bar_wait(&empty[(q + s) % R], ((q + s) / R) & 1);
        issue_w1(q + s + R);
      }
      bar_wait(w2full, chunk & 1);
    } else {
      bar_wait(w2full, chunk & 1);
    }
    __syncthreads();

    // B. depthwise 3x3 over the staged e: a warp per output column, a lane
    // per CPL channels; each staged e is read once and feeds the (up to)
    // three output rows it touches, taps in dy, dx order. d goes into planes.
    if constexpr (runs(DEPTHWISE)) {
      constexpr int CPL = L::EC / 32;
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
        store_run<T, CPL>(ds + (c / PL) * L::DPLANE + (oy * L::TW + ox) * PL + c % PL, acc[oy]);
      }
    }
    fence_async_smem();
    __syncthreads();

    // C. partial project GEMM: 64 pixels x 128 output channels per
    // warpgroup, over the chunk's 64 rows of W2 (four k16 steps).
    if (pcol < ncol) {
      wgmma_fence();
      const uint64_t da = smem_desc(ds + prow * PL, L::DPLANE * 2, 16 * PL);
      const uint64_t db = smem_desc(w2s + pcol * PL, ncol * 16, 16 * PL);
      if constexpr (runs(PROJECT))
#pragma unroll
        for (int kk = 0; kk < L::EC / PL; kk += 2)
          wgmma_bf16<128>(acc_p, da + ((kk * L::DPLANE * 2) >> 4), db + ((kk * ncol * 16) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      keep(acc_p);
    }
    __syncthreads();  // d, the W2 piece and the vectors are free again
    if (tid == PRODUCER && chunk + 1 < nchunks) issue_w2(chunk + 1);
  }

  // Epilogue: + b2 (+ x), store the pixels and channels that exist.
  if (pcol >= ncol) return;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = pcol + 8 * j + 2 * (lane % 4);
    if (col >= ncol) continue;
    float bv[2];
    load_run<T, 2>(b2 + co0 + col, bv);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = prow + 16 * warp + lane / 4 + 8 * h;
      const int oy = p / L::TW, ox = p % L::TW;
      const int gy = ty0 + oy, gx = tx0 + ox;
      if (gy >= H || gx >= W) continue;
      float o[2] = {acc_p[4 * j + 2 * h] + bv[0], acc_p[4 * j + 2 * h + 1] + bv[1]};
      if (residual) {
        const int c = co0 + col, hp = (oy + 1) * L::HW2 + ox + 1;
        float xv[2];
        load_run<T, 2>(xs + (c / PL) * L::XPLANE + hp * PL + c % PL, xv);
        o[0] += xv[0];
        o[1] += xv[1];
      }
      store_run<T, 2>(out + (static_cast<long long>(gy) * W + gx) * Co + co0 + col, o);
    }
  }
}

// f32 as 3xTF32 on wgmma. w1p and w2p are the packed weights of
// ops/dwblock.py::pack_dwblock_weights (f32 form). NW: output channels per
// project warpgroup. grid = (N * tiles_y * tiles_x, ceil(Co / NP)).
template <int NW>
__global__ void __launch_bounds__(NT, 1)
    dwblock_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1p,
                       const float* __restrict__ w2p, const float* __restrict__ b2,
                       float* __restrict__ out, int H, int W, int C, int E, int Co, int tiles_x,
                       int tiles_y, int residual) {
  using L = FLay;
  const int wcols = Co < NP ? Co : NP;
  const int R = L::ring(wcols);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [R]: a slice landed
  uint64_t* empty = full + L::MAX_RING;                // [R]: all expand warps read it
  uint64_t* w2full = empty + L::MAX_RING;              // the chunk's W2 piece landed
  float* w2s = reinterpret_cast<float*>(smem + L::BAR_BYTES);  // [2][16 planes][ncol][4], vectors
  float* es = reinterpret_cast<float*>(smem + L::BAR_BYTES + L::w2_bytes(wcols));  // e, then d
  unsigned char* ring = smem + L::fixed_bytes(wcols);

  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int tiles = tiles_x * tiles_y;
  const int tile = blockIdx.x % tiles;
  const long long n = blockIdx.x / tiles;
  const int ty0 = (tile / tiles_x) * L::TH, tx0 = (tile % tiles_x) * L::TW;
  const int co0 = blockIdx.y * NP;
  const int ncol = Co - co0 < NP ? Co - co0 : NP;  // rows of this block's W2 piece
  const float* b1s = w2s + 2 * L::EC * ncol;
  const float* bds = b1s + L::EC;
  const float* wds = bds + L::EC;  // [9][EC]
  x += n * H * W * C;
  out += n * H * W * Co;

  const int nchunks = (E + L::EC - 1) / L::EC;
  const int nslices = C / L::KS;
  const int total = nchunks * nslices;
  constexpr int PRODUCER = 3 * 128;  // warpgroup 3 loads the ring; its first thread the bulk copies
  auto slot_x = [&](int slot) { return reinterpret_cast<float*>(ring + slot * L::RING_SLOT); };
  auto slot_w1 = [&](int slot) {
    return reinterpret_cast<float*>(ring + slot * L::RING_SLOT + L::XS_BYTES);
  };

  // A thread of warpgroup 3 copies the same (up to) 3 of the 2 * HP
  // 16-byte pieces of every x slice: piece i (pixel i / 2, half i % 2) goes
  // to float 4i of the slot and comes from x at piece_src (channel 0; -1
  // outside the image, which the copy fills with zeros).
  constexpr int PIECES = (2 * L::HP + 127) / 128;
  int piece_src[PIECES];
#pragma unroll
  for (int j = 0; j < PIECES; ++j) {
    const int i = tid - PRODUCER + 128 * j, hp = i / 2;
    const int gy = ty0 + hp / L::HW2 - 1, gx = tx0 + hp % L::HW2 - 1;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    piece_src[j] = ok ? (gy * W + gx) * C + 4 * (i % 2) : -1;
  }
  // Slice q (of the flat (chunk, 8 channels) sequence, channels c0..c0+7)
  // into `slot`, by warpgroup 3: x's 8 channels of the halo pixels by
  // cp.async (each thread's completion is one of the slot's arrivals) and
  // the matching W1 slice by one bulk copy.
  auto issue_slice = [&](int slot, int q, int c0) {
    uint64_t* bar = &full[slot];
    if constexpr (runs(COPIES)) {
      float* xd = slot_x(slot);
#pragma unroll
      for (int j = 0; j < PIECES; ++j) {
        const int i = tid - PRODUCER + 128 * j;
        if (i < 2 * L::HP)
          cp_async16(xd + 4 * i, piece_src[j] >= 0 ? x + piece_src[j] + c0 : x,
                     piece_src[j] >= 0);
      }
      cp_async_arrive(bar);
      if (tid == PRODUCER)
        bulk_load(slot_w1(slot), w1p + static_cast<long long>(q) * L::W1S_ELEMS,
                  L::W1S_ELEMS * 4, bar);
    } else {
      bar_arrive(bar);
      if (tid == PRODUCER) bar_arrive(bar);
    }
  };
  // Warpgroup 3's place in the slice sequence: the next slice to issue and
  // its first channel, and the slice whose release it waits for next.
  int next_q = 0, next_c0 = 0;
  Cursor released;
  auto issue_next = [&](int slot) {
    issue_slice(slot, next_q, next_c0);
    ++next_q;
    next_c0 = next_c0 + L::KS == C ? 0 : next_c0 + L::KS;
  };
  // The chunk's W2 rows of this column block, big and small, then its b1,
  // bd and taps.
  auto issue_w2 = [&](int chunk) {
    const long long at =
        static_cast<long long>(chunk) * (2 * L::EC * Co + gridDim.y * L::VEC_ELEMS) +
        blockIdx.y * (2 * L::EC * NP + L::VEC_ELEMS);
    if constexpr (runs(COPIES))
      bulk_load(w2s, w2p + at, (2 * L::EC * ncol + L::VEC_ELEMS) * 4, w2full);
    else
      bar_arrive(w2full);
  };

  if (tid == 0) {
    for (int i = 0; i < R; ++i) {
      bar_init(&full[i], 128 + 1);  // warpgroup 3's cp.async arrivals, the bulk copy's
      bar_init(&empty[i], 12);      // the 12 warps of warpgroups 0-2
    }
    bar_init(w2full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == 3) {
    while (next_q < R && next_q < total) issue_next(next_q);
    if (tid == PRODUCER) issue_w2(0);
  }
  Cursor taken;  // the expand warps' place in the ring

  float acc_p[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc_p[i] = 0.0f;
  const int prow = (wg % 2) * 64, pcol = (wg / 2) * NW;  // this warpgroup's part of p
  const float2 zero = make_float2(0.0f, 0.0f);

  for (int chunk = 0; chunk < nchunks; ++chunk) {
    // A. expand, warpgroup wg < 3 on halo rows 64 wg ..; each slice of the
    // chunk is waited for on its slot's `full` and released on `empty` once
    // the wgmma group that read it has completed. That group is waited for
    // before the next slice's A values go into the registers it reads. The
    // tensor cores' sum runs over GROUP slices at a time (K = 128) and is
    // then added to e in f32.
    if (wg < 3) {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      keep(acc);
      const int r0 = wg * 64 + 16 * warp + g, r1 = r0 + 8;
      for (int s = 0; s < nslices; ++s) {
        bar_wait(&full[taken.slot], taken.phase);
        __syncwarp();
        const float* xs = slot_x(taken.slot);
        const Split a(r0 < L::HP ? *reinterpret_cast<const float2*>(xs + r0 * L::KS + 2 * t) : zero,
                      r1 < L::HP ? *reinterpret_cast<const float2*>(xs + r1 * L::KS + 2 * t) : zero);
        const float* w1s = slot_w1(taken.slot);
        wgmma_fence();
        if constexpr (runs(EXPAND))
          mma3<64>(acc, a, smem_desc(w1s, L::EC * 16, L::CORE),
                   smem_desc(w1s + L::KS * L::EC, L::EC * 16, L::CORE));
        wgmma_commit();
        wgmma_wait<0>();
        keep(acc);
        if (lane == 0) bar_arrive(&empty[taken.slot]);
        taken.next(R);
        const bool last = s + 1 == nslices;
        if (!last && (s + 1) % L::GROUP) continue;
        // fold the group's sum into e; after the last group + b1, ReLU6,
        // zero outside the image
        if (last) bar_wait(w2full, chunk & 1);  // b1 rides with the chunk's W2 piece
        if constexpr (runs(EXPAND_EPILOGUE)) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 8 * j + 2 * t;
            const float2 bb = *reinterpret_cast<const float2*>(b1s + col);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int hp = wg * 64 + 16 * warp + g + 8 * h;
              if (hp >= L::HP) continue;
              float2* e = reinterpret_cast<float2*>(es + hp * L::LDE + col);
              float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
              if (s >= L::GROUP) {
                const float2 before = *e;
                v = make_float2(before.x + v.x, before.y + v.y);
              }
              if (last) {
                const int gy = ty0 + hp / L::HW2 - 1, gx = tx0 + hp % L::HW2 - 1;
                const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
                v = inside ? make_float2(relu6(v.x + bb.x), relu6(v.y + bb.y)) : zero;
              }
              *e = v;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      }
    } else {
      // warpgroup 3 refills each slot of this chunk with the slice R later, once read
      for (int s = 0; s < nslices && next_q < total; ++s) {
        bar_wait(&empty[released.slot], released.phase);
        issue_next(released.slot);
        released.next(R);
      }
      bar_wait(w2full, chunk & 1);
    }
    __syncthreads();

    // B. depthwise 3x3 over e: a warp per output column, a lane per two
    // channels, taps in dy, dx order, d kept in registers until every
    // thread has read e, then written over it.
    {
      const int ox = tid / 32, c = 2 * lane;
      float2 dv[L::TH];
      if constexpr (runs(DEPTHWISE)) {
        float2 wt[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) wt[k] = *reinterpret_cast<const float2*>(wds + k * L::EC + c);
#pragma unroll
        for (int oy = 0; oy < L::TH; ++oy) dv[oy] = zero;
#pragma unroll
        for (int r = 0; r < L::TH + 2; ++r)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float2 ev = *reinterpret_cast<const float2*>(es + (r * L::HW2 + ox + dx) * L::LDE + c);
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
              const int oy = r - dy;
              if (oy < 0 || oy >= L::TH) continue;
              dv[oy].x = fmaf(ev.x, wt[dy * 3 + dx].x, dv[oy].x);
              dv[oy].y = fmaf(ev.y, wt[dy * 3 + dx].y, dv[oy].y);
            }
          }
        const float2 bias = *reinterpret_cast<const float2*>(bds + c);
#pragma unroll
        for (int oy = 0; oy < L::TH; ++oy)
          dv[oy] = make_float2(relu6(dv[oy].x + bias.x), relu6(dv[oy].y + bias.y));
      }
      __syncthreads();  // every read of e is done
      if constexpr (runs(DEPTHWISE))
#pragma unroll
        for (int oy = 0; oy < L::TH; ++oy)
          *reinterpret_cast<float2*>(es + (oy * L::TW + ox) * L::LDE + c) = dv[oy];
    }
    __syncthreads();

    // C. partial project GEMM: 64 pixels x NW output channels per
    // warpgroup, over the chunk's 64 rows of W2 (eight k8 steps), at most 64
    // columns at a time, summed by the tensor cores into `part` and then
    // added to acc_p in f32.
    if (pcol < ncol) {
      constexpr int NH = NW < 64 ? NW : 64;
      const int r0 = prow + 16 * warp + g, r1 = r0 + 8;
#pragma unroll
      for (int half = 0; half < NW / NH; ++half) {
        float part[NH / 2];
#pragma unroll
        for (int i = 0; i < NH / 2; ++i) part[i] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < L::EC / 8; ++kk) {
          const Split a(*reinterpret_cast<const float2*>(es + r0 * L::LDE + 8 * kk + 2 * t),
                        *reinterpret_cast<const float2*>(es + r1 * L::LDE + 8 * kk + 2 * t));
          const float* wb = w2s + (2 * kk * ncol + pcol + half * NH) * L::PLANE;
          wgmma_fence();
          if constexpr (runs(PROJECT))
            mma3<NH>(part, a, smem_desc(wb, ncol * 16, L::CORE),
                     smem_desc(wb + L::EC * ncol, ncol * 16, L::CORE));
          wgmma_commit();
          wgmma_wait<1>();  // this step's A is in distinct registers from the last
        }
        wgmma_wait<0>();
        keep(part);
#pragma unroll
        for (int i = 0; i < NH / 2; ++i) acc_p[half * NH / 2 + i] += part[i];
      }
    }
    __syncthreads();  // d and the W2 piece are free again
    if (tid == PRODUCER && chunk + 1 < nchunks) issue_w2(chunk + 1);
  }

  // Epilogue: + b2 (+ x, from device memory), store the pixels and channels
  // that exist.
  if (pcol >= ncol) return;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = pcol + 8 * j + 2 * t;
    if (col >= ncol) continue;
    const float2 bv = *reinterpret_cast<const float2*>(b2 + co0 + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = prow + 16 * warp + g + 8 * h;
      const int gy = ty0 + p / L::TW, gx = tx0 + p % L::TW;
      if (gy >= H || gx >= W) continue;
      const long long pix = static_cast<long long>(gy) * W + gx;
      float2 o = make_float2(acc_p[4 * j + 2 * h] + bv.x, acc_p[4 * j + 2 * h + 1] + bv.y);
      if (residual) {
        const float2 xv = *reinterpret_cast<const float2*>(x + pix * C + co0 + col);
        o.x += xv.x;
        o.y += xv.y;
      }
      *reinterpret_cast<float2*>(out + pix * Co + co0 + col) = o;
    }
  }
}

// Grid of one block per tile and 256 output channels; 0 or the CUDA error.
int grid_of(int N, int H, int W, int Co, int th, int tw, int* tiles_x, int* tiles_y,
            dim3* grid) {
  *tiles_x = (W + tw - 1) / tw;
  *tiles_y = (H + th - 1) / th;
  const long long blocks = static_cast<long long>(N) * *tiles_x * *tiles_y;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  *grid = dim3(static_cast<unsigned>(blocks), (Co + NP - 1) / NP);
  return 0;
}

template <int NW>
int launch_f32(const void* x, const void* w1p, const void* w2p, const void* b2, void* out,
               int N, int H, int W, int C, int E, int Co, int residual, void* stream) {
  using L = FLay;
  const int smem = L::smem_bytes(Co < NP ? Co : NP);
  cudaError_t rc = allow_smem(dwblock_f32_kernel<NW>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int tiles_x, tiles_y;
  dim3 grid;
  if (int bad = grid_of(N, H, W, Co, L::TH, L::TW, &tiles_x, &tiles_y, &grid)) return bad;
  dwblock_f32_kernel<NW><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1p),
      static_cast<const float*>(w2p), static_cast<const float*>(b2), static_cast<float*>(out),
      H, W, C, E, Co, tiles_x, tiles_y, residual);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* x, const void* w1p, const void* w2p, const void* b2, void* out,
                int N, int H, int W, int C, int E, int Co, int residual, void* stream) {
  using T = __nv_bfloat16;
  using L = BLay;
  const int smem = L::smem_bytes(C);
  if (L::ring(C) < 2 || smem > SMEM_LIMIT || (residual && C != Co))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = allow_smem(dwblock_bf16_kernel, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int tiles_x, tiles_y;
  dim3 grid;
  if (int bad = grid_of(N, H, W, Co, L::TH, L::TW, &tiles_x, &tiles_y, &grid)) return bad;
  dwblock_bf16_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1p), static_cast<const T*>(w2p),
      static_cast<const T*>(b2), static_cast<T*>(out), H, W, C, E, Co, tiles_x, tiles_y,
      residual);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() right after the launch (0 on success) and
// reads the weights packed by ops/dwblock.py::pack_dwblock_weights.
int dwblock_bf16(const void* x, const void* w1_packed, const void* w2_packed, const void* b2,
                 void* out, int N, int H, int W, int C, int E, int Co, int residual,
                 void* stream) {
  return launch_bf16(x, w1_packed, w2_packed, b2, out, N, H, W, C, E, Co, residual, stream);
}

int dwblock_f32(const void* x, const void* w1_packed, const void* w2_packed, const void* b2,
                void* out, int N, int H, int W, int C, int E, int Co, int residual,
                void* stream) {
  if (C % FLay::KS || E % 8 || Co % 8 || (residual && C != Co) || C > MAX_C)
    return static_cast<int>(cudaErrorInvalidValue);
  // the project's columns per warpgroup: the fewest that cover the widest
  // column block, rounded up to a multiple of 16 and split in two
  const int need = round_up(Co < NP ? Co : NP, 16) / 2;
  decltype(&launch_f32<16>) launch = need <= 16   ? &launch_f32<16>
                                    : need <= 32 ? &launch_f32<32>
                                    : need <= 64 ? &launch_f32<64>
                                                 : &launch_f32<128>;
  return launch(x, w1_packed, w2_packed, b2, out, N, H, W, C, E, Co, residual, stream);
}

// The packed-weight layouts the kernels read, for the pack to be held
// against: E columns per chunk, rows of W1 per copy, channels per plane,
// output channels per block, and the multiple C is padded to.
void dwblock_bf16_layout(int* chunk, int* slice_rows, int* plane, int* column_block,
                         int* k_step) {
  *chunk = BLay::EC;
  *slice_rows = BLay::KS;
  *plane = BLay::PLANE;
  *column_block = NP;
  *k_step = 16;
}

void dwblock_f32_layout(int* chunk, int* slice_rows, int* plane, int* column_block,
                        int* k_step) {
  *chunk = FLay::EC;
  *slice_rows = FLay::KS;
  *plane = FLay::PLANE;
  *column_block = NP;
  *k_step = 8;
}

const char* dwblock_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
