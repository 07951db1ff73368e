// The ConvTWA recurrence on Hopper (sm_90a), CUDA C++: two kernels.
//
// Replaces iip_uavsal_saliency_tpu/ops/pallas_twa.py::twa_scan_pallas (the
// Pallas TPU kernel). For every video v of a clip and every frame s in order
//
//     g   = sigmoid(gx_s + conv3x3_same(h_{s-1}, W_h))
//     h_s = g * x_s + (1 - g) * h_{s-1}
//
// as an implicit GEMM: M = H*W output pixels, N = C output channels,
// K = 9*C (3x3 taps x input channels), accumulated in f32, gate and lerp in
// f32 in the epilogue, one rounding at the store of h_s. Frame s reads
// h_{s-1} from ys[v, s-1] (or h0) and writes ys[v, s]: no copy of h.
//
// What bounds it on an H100: at the flagship 45x80x256 one frame is
// 2*3600*2304*256 = 4.25 GFLOP against ~8.6 MB of x, gx, h_{s-1}, h_s and
// W_h, so it is compute-bound (about 4.3 us at the 989 TFLOP/s bf16 peak vs
// 2.6 us for the bytes at 3.35 TB/s).
//
// twa_clip_kernel (bf16; `twa_scan_bf16`): ONE cooperative launch per clip,
// the counterpart of the TPU kernel's single pallas_call with W_h resident
// in VMEM. The grid is at most what is resident at once (one block per SM at
// this shared-memory size; the launch is refused otherwise), and every block
// loops over all S frames.
//   - A block owns a slice of PN = 32 output channels and keeps that slice
//     of W_h (9*C x 32, 147 KB at C = 256) in shared memory for the whole
//     clip: W_h is read from L2 once per clip, not once per tile and frame.
//   - Its output tiles are TR image rows of one video: the most that give
//     at most 256 GEMM rows and fit, with their halo, beside the slice
//     (`clip_tile_rows`, the one place that decides it; 3 rows = 240 pixels
//     at W = 80). Per tile and frame the rows with
//     their one-pixel halo ((TR+2) x (W+2) pixels, zeros outside the image
//     written by the loader) are staged once, in chunks of 32 input
//     channels through a 3-deep cp.async ring, and the 9 taps are shifted
//     reads of that one copy: ldmatrix takes an address per row, so a shift
//     costs nothing. h_{s-1} is read from L2 once per tile, not once per tap.
//   - Tensor cores through ldmatrix + mma.sync m16n8k16 (f32 accumulators in
//     registers; 8 warps of 32 rows x 32 columns). Both operands
//     are stored with a 16-byte-chunk XOR swizzle, so the eight rows of an
//     ldmatrix phase fall on distinct banks whatever the shift, and the
//     fragments of K step k + 1 are loaded while step k multiplies.
//   - The epilogue works on the accumulator's own rows and columns straight
//     from registers (no f32 tile in shared memory). The slice's columns
//     are stored permuted so that a lane's 8 accumulator columns are 8
//     consecutive channels: x_s, gx_s, h_{s-1} and h_s move as one 16-byte
//     access per row, asked for before the GEMM and used after it.
//   - Frames stay in order across blocks through per-tile counters in a
//     scratch tensor the wrapper zeroes: after storing h_s of a tile every
//     thread fences, the block's thread 0 adds 1 to the tile's counter, and
//     a block starts frame s of a tile once the counters of the tile and of
//     its row neighbours have reached (C / 32) * s. h_{s-1} is then read
//     with cp.async.cg and ld.global.cg (L2 only, never the read-only path).
//     Dependencies point to earlier frames only and all blocks are resident,
//     so the wait cannot deadlock.
//   - No split-K, no atomics on data: a tile's bits do not depend on which
//     block computes it, so a split of V gives the bits of the whole.
//
// twa_step_bf16_kernel (bf16; `twa_step_bf16`): one frame per launch, the
// host launches frames in order (ops/twa.py). It takes the bf16 shapes the
// persistent kernel's gate refuses: C % 8 == 0 with C % 32 != 0, and widths
// whose halo tile does not fit beside the W_h slice (above 142 at C = 256:
// the 90x160 state of 720x1280 serving). One 90x160x256 frame is the GEMM
// of four flagship frames, 17.0 GFLOP: 17.2 us at the 989 TFLOP/s bf16 peak
// against 30.7 MB (9.2 us at 3.35 TB/s), bound by operations. Design:
//   - bf16 wgmma m64n256k16, f32 accumulators in registers, one product per
//     k16 step and no fold: gx is added to the sums in f32 in the epilogue,
//     and h_s is rounded once, to bf16, at the store.
//   - The GEMM's rows are positions of the image padded by one zero column
//     each side (pitch W + 2), so that every tap is one shift of the row
//     index. A block owns BM = 128 consecutive positions of one video and
//     BN = 256 output channels (all of them at C = 256), as two consumer
//     warpgroups of 64 rows; the rows that fall on a pad column (2 / (W + 2)
//     of the work) are dropped in the epilogue. 114 blocks at 90x160, one
//     wave on 132 SMs.
//   - Why 128 x 256: a block reads its columns of the packed W_h (1.18 MB at
//     C = 256) from L2 once per 128 positions, and every column block stages
//     h_{s-1} again; a 256-wide block stages it once, and m64n256 reads the
//     most columns per byte of A from shared memory. On an H100, 128 x 64
//     and 128 x 128 blocks with a producer warp took 67 to 71 us a frame at
//     90x160, and two 108 KB blocks an SM without one 68 (PERF.md,
//     Findings). The 128 accumulators a thread holds need the producer
//     warpgroup's registers: it keeps 40 (setmaxnreg), the consumers take
//     232 (with a producer warp instead, ptxas spilled and it ran slower).
//   - h_{s-1} staged once per tile and chunk of KC = 64 channels: for each
//     tap row dy the 130 positions from one before the tile's first to one
//     past its last (whatever W), zeros on pad columns and outside the
//     image, by 16-byte cp.async into wgmma's K-major layout without
//     swizzle, planes of 8 channels [dy][plane][131 positions][8] (the pad
//     position puts the 8 planes of a pixel on distinct banks), two
//     buffers. A is read by wgmma from shared memory by descriptor: tap
//     (dy, dx) starts dy rows and dx positions (16 dx bytes) into the
//     buffer, so h_{s-1} leaves L2 once per tile and chunk, not once per tap.
//     Chunk ch + 1 is staged once chunk ch's first tap is issued and every
//     group of chunk ch - 1 has completed, so the wgmma pipeline is never
//     drained between chunks.
//   - B: `ops/twa.py::pack_twa_weights_bf16` lays W_h out once, at load, as
//     [chunk][tap][plane][N padded to 256][8] (C padded to 64), the bits of
//     the bf16 W_h the persistent kernel reads. One tap of a chunk (KC x BN,
//     32 KB) is a slot of a 4-deep ring, 8 bulk copies of BN x 16 bytes (one
//     per plane) on one mbarrier, fed by the producer warpgroup's first
//     thread.
//   - Epilogue from registers, on the accumulator's own rows and columns:
//     gx_s, x_s and h_{s-1} of the block's rows are asked into L2 before the
//     GEMM (which waits for none of them) and read after it, 8 column groups
//     at a time beside the 128 accumulators; gate and lerp in f32, one
//     rounding at the store of h_s.
//   - No split-K, no atomics: a video's bits do not depend on the others.
//
// twa_step_f32_kernel (f32; `twa_step_f32`): one frame per launch, the
// implicit GEMM on the tensor cores as 3xTF32 on wgmma. Each f32 operand v
// is split into TF32 parts big = rna(v) and small = rna(v - big), and a
// product is accumulated in f32 as small.big + big.small + big.big (the
// dropped small.small is about 2^-22 of it). At the flagship frame that is
// 3 x 4.2467 GFLOP at the 495 TFLOP/s TF32 peak, 25.74 us, against 17.1 MB
// of x, gx, h_{s-1}, h_s and W_h in f32 (5.1 us at 3.35 TB/s): bound by
// operations. Design:
//   - Tile: a block owns BM = 128 consecutive pixels (GEMM rows) of one
//     video, as two consumer warpgroups of 64 rows that share every B slot,
//     and a column block of BN = 64 output channels; a producer warp feeds
//     the ring. At 45x80x256 that is 29 x 4 = 116 blocks, one wave on 132
//     SMs, and 116 x 9*256*64 x 8 bytes = 137 MB of L2 reads of the split
//     W_h per frame (64 rows x 128 channels would read 269 MB, and 256
//     rows x 64 channels fill 60 SMs).
//   - h_{s-1} staged once per tile: for each tap row dy the tile's run of
//     pixels with one pixel each side (3 x 130 pixels, whatever W), in
//     chunks of KC = 32 channels through two cp.async buffers (160-byte
//     pixel pitch: the float2 reads of a half-warp fall on distinct banks).
//     Pixels outside the image rows are zeros written by the loader; a tap
//     that crosses a row's end reads zero in registers. A is taken from
//     registers in f32 and split there, so a tap's shift is an address:
//     h_{s-1} leaves L2 once per tile and chunk, not once per tap.
//   - B: `ops/twa.py::pack_twa_weights` splits W_h once, at load, and lays
//     each column block out as [chunk][tap][k8 step][big, small][plane of
//     4 channels][64 columns][4], C padded to 32 and N to 64 with zeros, so
//     that one tap of a chunk (4 k8 steps, 16 KB) is one bulk copy into a
//     slot of the ring, on mbarriers (6 slots).
//   - The tensor cores' f32 sums are not IEEE round-to-nearest: they sum
//     at most FOLD_TAPS = 3 taps of a chunk (K = 96) before the partial is
//     added in f32 to sums that start as gx (tests/test_torch_twa_f32.py
//     holds the fold length in f64: all of K in one sum would not hold
//     TOL_F32). On an H100 the kernel holds twa_scan_ref within 2.04e-6
//     over 20 flagship frames (chip_smoke.py).
//   - Three register sets of A, one wgmma group in flight: step k + 1's A
//     is loaded and split while step k multiplies, into the set of step
//     k - 2, whose group has completed (a set is written again only then).
//   - Epilogue from registers: x_s, gx_s and h_{s-1} for the accumulator's
//     own rows and columns are loaded before the GEMM, gate and lerp run in
//     f32, and each element is stored once as f32.
//   - No split-K, no atomics: a video's bits do not depend on the others.
//
// Requirements (checked by the Python wrapper): C % 8 == 0 (C % 32 == 0 for
// the persistent kernel), all pointers 16-byte aligned, tensors contiguous
// in (V, S, H, W, C) / (V, H, W, C) order, W_h contiguous in HWIO order
// (3, 3, C, C) for the persistent kernel and packed by `pack_twa_weights_bf16`
// and `pack_twa_weights` for the per-frame ones. Any H, W >= 1 for the
// per-frame kernels.

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <map>
#include <mutex>
#include <utility>

#include "hopper.cuh"
#include "smem.cuh"

namespace {

constexpr int SMEM_LIMIT = 232448;  // 227 KB, the most a Hopper block can use

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// 16-byte asynchronous copy from device to shared memory through L2 only;
// `valid` false writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// sigmoid in f32 on the special-function unit (ex2.approx, rcp.approx): a
// few f32 ulps from expf and a full division, far inside the one rounding to
// bf16 that follows, at a third of their cost.
__device__ __forceinline__ float gate(float z) {
  return __fdividef(1.0f, 1.0f + __expf(-z));
}

__device__ __forceinline__ float2 unpack(unsigned two_bf16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&two_bf16));
}

// ---------------------------------------------------------------------------
// The per-frame kernel in f32: 3xTF32 on wgmma (see the header).

// Timing builds only (tools/k1_probe --route step): a bit mask of parts of
// the per-frame kernels compiled out. Such a build computes wrong values; the
// port never builds one. SPLIT and FOLD are the f32 kernel's alone (the bf16
// kernel's wgmma reads A from shared memory itself and sums all of K).
#ifndef STEP_SKIP
#define STEP_SKIP 0
#endif
enum StepPart {
  STEP_MMA = 0,        // the wgmma
  STEP_SPLIT = 1,      // A's loads from the staged copy and their split (f32)
  STEP_FOLD = 2,       // the partial sums' drain and add (all of K in one sum; f32)
  STEP_COPIES = 3,     // the bulk copies of W_h (the producer arrives instead)
  STEP_HANDSHAKE = 4,  // the ring's mbarrier waits and arrivals (and the copies)
  STEP_STAGING = 5,    // the cp.async of h_{s-1}
  STEP_EPILOGUE = 6,   // the epilogue's loads and gate (the sums are stored)
};
__host__ __device__ constexpr bool step_runs(StepPart p) { return !((STEP_SKIP >> p) & 1); }

struct F32Step {
  static constexpr int BM = 128;             // GEMM rows (pixels) per block
  static constexpr int BN = 64;              // output channels per block: the pack's column block
  static constexpr int KC = 32;              // input channels per staged chunk: the pack's chunk
  static constexpr int KSTEP = 8;            // channels of one wgmma k8 step
  static constexpr int PLANE = 4;            // channels per 16-byte core-matrix row of B
  static constexpr int CONSUMERS = 256;      // two warpgroups of 64 rows
  static constexpr int NT = CONSUMERS + 32;  // and the producer warp
  static constexpr int SEG = BM + 2;         // staged pixels per tap row
  static constexpr int PITCH = KC + 8;       // floats per staged pixel (160 bytes)
  static constexpr int A_BYTES = round_up(3 * SEG * PITCH * 4, 128);  // one staged chunk
  static constexpr int STEP_FLOATS = 2 * KSTEP * BN;        // one k8 step of B, big and small
  static constexpr int SLOT_FLOATS = KC / KSTEP * STEP_FLOATS;  // one tap of a chunk: 16 KB
  static constexpr int SLOT_BYTES = SLOT_FLOATS * 4;
  static constexpr int FOLD_TAPS = 3;        // taps the tensor cores sum at a time (K = 96)
  static constexpr int MAX_RING = 8;
  static constexpr int BAR_BYTES = 256;      // 2 * MAX_RING mbarriers
  static constexpr int RING = (SMEM_LIMIT - BAR_BYTES - 2 * A_BYTES) / SLOT_BYTES < MAX_RING
                                  ? (SMEM_LIMIT - BAR_BYTES - 2 * A_BYTES) / SLOT_BYTES
                                  : MAX_RING;
  static constexpr int SMEM = BAR_BYTES + 2 * A_BYTES + RING * SLOT_BYTES;
};
static_assert(F32Step::RING >= 2 && F32Step::SMEM <= SMEM_LIMIT &&
                  F32Step::A_BYTES % 128 == 0 && F32Step::SLOT_BYTES % 128 == 0 &&
                  8 * 2 * F32Step::MAX_RING <= F32Step::BAR_BYTES,
              "f32 per-frame layout");
static_assert(9 % F32Step::FOLD_TAPS == 0, "a chunk's last tap ends a fold group");

// The consumer warpgroups' own barrier (the producer warp is not in it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(F32Step::CONSUMERS) : "memory");
}

// grid = (ceil(H*W / BM), ceil(C / BN), V). `wp` is W_h packed by
// ops/twa.py::pack_twa_weights; `vstride` steps x, gx and out from one video
// to the next, `hstride` steps h_{s-1}.
__global__ void __launch_bounds__(F32Step::NT, 1)
    twa_step_f32_kernel(const float* __restrict__ x, const float* __restrict__ gx,
                        const float* __restrict__ hprev, const float* __restrict__ wp,
                        float* __restrict__ out, long long vstride, long long hstride, int H,
                        int W, int C) {
  using L = F32Step;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [RING]: a slot's W_h landed
  uint64_t* empty = full + L::MAX_RING;                // [RING]: all consumer warps read it
  float* abuf = reinterpret_cast<float*>(smem + L::BAR_BYTES);  // [2][3 * SEG][PITCH]
  float* ring = reinterpret_cast<float*>(smem + L::BAR_BYTES + 2 * L::A_BYTES);

  const int tid = threadIdx.x;
  const int M = H * W;
  const int m0 = blockIdx.x * L::BM, n0 = blockIdx.y * L::BN;
  const long long v = blockIdx.z;
  const int nchunk = (C + L::KC - 1) / L::KC;
  const int total = 9 * nchunk;  // ring slots of the tile, one per (chunk, tap)

  if (tid == 0) {
    for (int i = 0; i < L::RING; ++i) {
      bar_init(&full[i], 1);                   // the producer's arrival, with the copy's bytes
      bar_init(&empty[i], L::CONSUMERS / 32);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= L::CONSUMERS) {
    // The producer warp's first lane streams the block's column block of
    // the packed W_h through the ring, each slot refilled once released.
    if (tid != L::CONSUMERS || !step_runs(STEP_HANDSHAKE)) return;
    const float* src = wp + static_cast<long long>(blockIdx.y) * total * L::SLOT_FLOATS;
    Cursor fill;
    for (int q = 0; q < total; ++q) {
      if (q >= L::RING) bar_wait(&empty[fill.slot], fill.phase ^ 1);
      if constexpr (step_runs(STEP_COPIES))
        bulk_load(ring + fill.slot * L::SLOT_FLOATS,
                  src + static_cast<long long>(q) * L::SLOT_FLOATS, L::SLOT_BYTES, &full[fill.slot]);
      else
        bar_arrive(&full[fill.slot]);
      fill.next(L::RING);
    }
    return;
  }

  x += v * vstride;
  gx += v * vstride;
  out += v * vstride;
  hprev += v * hstride;
  const int wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = wg * 64 + 16 * warp + g;  // this thread's GEMM rows r0 and r0 + 8 of the tile
  int col[2];                              // their pixels' columns in the image
#pragma unroll
  for (int h = 0; h < 2; ++h) col[h] = (m0 + r0 + 8 * h) % W;

  // Chunk `chunk` of h_{s-1} into its buffer: for tap row dy = 0, 1, 2 the
  // pixels m0 + (dy - 1) * W - 1 .. + SEG - 1 (flat index; zeros outside the
  // image rows and past C), 16-byte cp.async, consecutive threads on
  // consecutive pieces of a pixel.
  auto stage = [&](int chunk) {
    float* dst = abuf + (chunk & 1) * (L::A_BYTES / 4);
    const int c0 = chunk * L::KC;
    if constexpr (step_runs(STEP_STAGING))
      for (int e = tid; e < 3 * L::SEG * (L::KC / 4); e += L::CONSUMERS) {
        const int pix = e / (L::KC / 4), piece = e % (L::KC / 4);
        const int dy = pix / L::SEG;
        const int q = m0 + (dy - 1) * W - 1 + (pix - dy * L::SEG);
        const int c = c0 + 4 * piece;
        const bool ok = q >= 0 && q < M && c < C;
        cp_async16(dst + pix * L::PITCH + 4 * piece,
                   ok ? hprev + static_cast<long long>(q) * C + c : hprev, ok);
      }
    cp_async_commit();
  };
  stage(0);

  // The epilogue's operands for the accumulator's rows and columns, asked
  // for now: the sums start as gx_s; x_s and h_{s-1} wait in registers. Of
  // an m64n64 accumulator a thread holds, for each 8 columns j, [4j], [4j +
  // 1] at (row r0, columns 8j + 2t, + 1) and [4j + 2], [4j + 3] at row r0 + 8.
  float sum[32], xv[32], hv[32];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + r0 + 8 * h, n = n0 + 8 * j + 2 * t, i = 4 * j + 2 * h;
      float2 gv = make_float2(0.0f, 0.0f), xx = gv, hh = gv;
      if (step_runs(STEP_EPILOGUE) && p < M && n < C) {
        const long long off = static_cast<long long>(p) * C + n;
        gv = __ldg(reinterpret_cast<const float2*>(gx + off));
        xx = __ldg(reinterpret_cast<const float2*>(x + off));
        hh = __ldg(reinterpret_cast<const float2*>(hprev + off));
      }
      sum[i] = gv.x, sum[i + 1] = gv.y;
      xv[i] = xx.x, xv[i + 1] = xx.y;
      hv[i] = hh.x, hv[i + 1] = hh.y;
    }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  Split a[3];  // A of three k8 steps: the one being read, the one before, the next
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[b].big[i] = a[b].small[i] = 0u;
  const float2 zero = make_float2(0.0f, 0.0f);
  Cursor taken;      // the consumers' place in the ring
  int pending = -1;  // a slot whose last wgmma group may still be in flight
  constexpr int STEPS = 9 * (L::KC / L::KSTEP);  // k8 steps of a chunk, tap by tap

  for (int ch = 0; ch < nchunk; ++ch) {
    cp_async_wait<0>();  // this thread's part of chunk ch landed
    consumers_sync();    // everyone's did, and chunk ch - 1's buffer is read
    if (ch + 1 < nchunk) stage(ch + 1);
    const float* As = abuf + (ch & 1) * (L::A_BYTES / 4);
    // A of k8 step s of the chunk (tap s / 4, its channels 8 (s % 4) ..),
    // split into set s % 3; a tap that crosses the row's end reads the
    // conv's zero padding
    auto load_a = [&](int s) {
      const int tap = s / 4, dy = tap / 3, dx = tap % 3 - 1;
      const bool ok0 = dx == 0 || (dx < 0 ? col[0] > 0 : col[0] < W - 1);
      const bool ok1 = dx == 0 || (dx < 0 ? col[1] > 0 : col[1] < W - 1);
      const float* a0 = As + (dy * L::SEG + r0 + 1 + dx) * L::PITCH + 2 * t + L::KSTEP * (s % 4);
      if constexpr (step_runs(STEP_SPLIT)) {
        a[s % 3] = Split(ok0 ? *reinterpret_cast<const float2*>(a0) : zero,
                         ok1 ? *reinterpret_cast<const float2*>(a0 + 8 * L::PITCH) : zero);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[s % 3].big[i] = a[s % 3].small[i] = tid + s;
      }
    };
    load_a(0);
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int tap = s / 4, k = s % 4;
      if (k == 0 && step_runs(STEP_HANDSHAKE)) {
        bar_wait(&full[taken.slot], taken.phase);
        __syncwarp();  // the polls diverge; the wgmma is warp-aligned
      }
      const float* bk = ring + taken.slot * L::SLOT_FLOATS + k * L::STEP_FLOATS;
      wgmma_fence();
      if constexpr (step_runs(STEP_MMA))
        mma3<L::BN>(acc, a[s % 3], smem_desc(bk, L::BN * 16, 8 * 16),
                    smem_desc(bk + L::KSTEP * L::BN, L::BN * 16, 8 * 16));
      wgmma_commit();
      // the next step's A while this one multiplies, into the set that
      // step s - 2 read (complete: waited for in the last step)
      if (s + 1 < STEPS) load_a(s + 1);
      wgmma_wait<1>();  // step s - 1 completed: its A set is free
      keep(a[(s + 2) % 3].big);
      keep(a[(s + 2) % 3].small);
      if (k == 0 && pending >= 0) {  // and so did the previous tap's last group
        if (step_runs(STEP_HANDSHAKE) && lane == 0) bar_arrive(&empty[pending]);
        pending = -1;
      }
      if (k < 3) continue;
      const bool last = ch + 1 == nchunk && tap == 8;
      if (tap % L::FOLD_TAPS == L::FOLD_TAPS - 1 && (step_runs(STEP_FOLD) || last)) {
        // drain, release the slot, and add the tensor cores' partial in f32
        wgmma_wait<0>();
        keep(acc);
#pragma unroll
        for (int b = 0; b < 3; ++b) keep(a[b].big), keep(a[b].small);
        if (step_runs(STEP_HANDSHAKE) && lane == 0) bar_arrive(&empty[taken.slot]);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          sum[i] += acc[i];
          acc[i] = 0.0f;
        }
      } else {
        pending = taken.slot;
      }
      taken.next(L::RING);
    }
  }

  // Epilogue on the accumulator's own rows and columns: gate and lerp in
  // f32, one f32 store per element.
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + r0 + 8 * h, n = n0 + 8 * j + 2 * t, i = 4 * j + 2 * h;
      if (p >= M || n >= C) continue;
      float2 o = make_float2(sum[i], sum[i + 1]);
      if constexpr (step_runs(STEP_EPILOGUE)) {
        const float g0 = 1.0f / (1.0f + expf(-sum[i]));
        const float g1 = 1.0f / (1.0f + expf(-sum[i + 1]));
        o = make_float2(g0 * xv[i] + (1.0f - g0) * hv[i], g1 * xv[i + 1] + (1.0f - g1) * hv[i + 1]);
      }
      *reinterpret_cast<float2*>(out + static_cast<long long>(p) * C + n) = o;
    }
}

int launch_step_f32(const void* x, const void* gx, const void* hprev, const void* wp, void* out,
                    long long vstride, long long hstride, int V, int H, int W, int C,
                    void* stream) {
  using L = F32Step;
  if (C % L::KSTEP) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = allow_smem(twa_step_f32_kernel, L::SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((H * W + L::BM - 1) / L::BM, (C + L::BN - 1) / L::BN, V);
  twa_step_f32_kernel<<<grid, L::NT, L::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(gx),
      static_cast<const float*>(hprev), static_cast<const float*>(wp), static_cast<float*>(out),
      vstride, hstride, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The per-frame kernel in bf16: wgmma with A and B from shared memory (see
// the header).

struct Bf16Step {
  static constexpr int BM = 128;             // GEMM rows (padded positions) per block
  static constexpr int BN = 256;             // output channels per block: the pack's column block
  static constexpr int KC = 64;              // input channels per staged chunk: the pack's chunk
  static constexpr int PLANE = 8;            // channels per 16-byte core-matrix row
  static constexpr int PLANES = KC / PLANE;  // planes of a chunk
  static constexpr int CONSUMERS = 256;      // two warpgroups of 64 rows
  static constexpr int NT = CONSUMERS + 128; // and the producer warpgroup
  static constexpr int CONSUMER_REGS = 232;  // registers a thread after setmaxnreg
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int SEG = BM + 2;         // staged positions per tap row
  // a plane of a tap row, 2096 bytes: the 8 planes of a pixel start 48
  // bytes apart in the banks, and fill all 8 once
  static constexpr int PLANE_BYTES = (SEG + 1) * 16;
  static constexpr int ROW_BYTES = PLANES * PLANE_BYTES;     // a tap row of a chunk
  static constexpr int A_BYTES = round_up(3 * ROW_BYTES, 128);  // one staged chunk
  static constexpr int COPIES = 3 * SEG * PLANES;            // 16-byte pieces of a chunk
  static constexpr int PER_THREAD = (COPIES + CONSUMERS - 1) / CONSUMERS;
  static constexpr int SLOT_BYTES = KC * BN * 2;             // one tap of a chunk: 32 KB
  static constexpr int MAX_RING = 8;
  static constexpr int BAR_BYTES = 256;      // 2 * MAX_RING mbarriers
  static constexpr int RING = (SMEM_LIMIT - BAR_BYTES - 2 * A_BYTES) / SLOT_BYTES < MAX_RING
                                  ? (SMEM_LIMIT - BAR_BYTES - 2 * A_BYTES) / SLOT_BYTES
                                  : MAX_RING;
  static constexpr int SMEM = BAR_BYTES + 2 * A_BYTES + RING * SLOT_BYTES;
};
static_assert(Bf16Step::RING >= 3 && Bf16Step::SMEM <= SMEM_LIMIT &&
                  Bf16Step::CONSUMERS == F32Step::CONSUMERS &&  // consumers_sync's count
                  Bf16Step::A_BYTES % 128 == 0 && Bf16Step::CONSUMERS % Bf16Step::PLANES == 0 &&
                  8 * 2 * Bf16Step::MAX_RING <= Bf16Step::BAR_BYTES &&
                  Bf16Step::CONSUMER_REGS * Bf16Step::CONSUMERS +
                          Bf16Step::PRODUCER_REGS * (Bf16Step::NT - Bf16Step::CONSUMERS) <=
                      65536,
              "bf16 per-frame layout");

// grid = (ceil(H * (W + 2) / BM), ceil(C / BN), V). `wp` is W_h packed by
// ops/twa.py::pack_twa_weights_bf16; `vstride` steps x, gx and out from one
// video to the next, `hstride` steps h_{s-1}.
__global__ void __launch_bounds__(Bf16Step::NT, 1)
    twa_step_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ gx,
                         const __nv_bfloat16* __restrict__ hprev,
                         const __nv_bfloat16* __restrict__ wp, __nv_bfloat16* __restrict__ out,
                         long long vstride, long long hstride, int H, int W, int C) {
  using L = Bf16Step;
  constexpr int NJ = L::BN / 8;  // 8-column groups of the accumulator
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [RING]: a slot's W_h landed
  uint64_t* empty = full + L::MAX_RING;                // [RING]: all consumer warps read it
  unsigned char* abuf = smem + L::BAR_BYTES;           // [2][3 tap rows][PLANES][SEG + 1][8]
  unsigned char* ring = abuf + 2 * L::A_BYTES;

  const int tid = threadIdx.x;
  const int WP = W + 2, MP = H * WP;  // the padded image's pitch and positions
  const int m0 = blockIdx.x * L::BM, n0 = blockIdx.y * L::BN;
  const long long v = blockIdx.z;
  const int nchunk = (C + L::KC - 1) / L::KC;
  const int total = 9 * nchunk;  // ring slots of the tile, one per (chunk, tap)
  const int npad = (C + L::BN - 1) / L::BN * L::BN;

  if (tid == 0) {
    for (int i = 0; i < L::RING; ++i) {
      bar_init(&full[i], 1);                   // the producer's arrival, with the copies' bytes
      bar_init(&empty[i], L::CONSUMERS / 32);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, read so that every lane of a warp branches alike
  // (setmaxnreg is executed by whole warpgroups)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == L::CONSUMERS / 128) {
    // The producer warpgroup gives its registers to the consumers; its
    // first thread streams the block's columns of the packed W_h through
    // the ring: slot q is tap q % 9 of chunk q / 9, its PLANES planes of
    // BN x 8 channels, each slot refilled once released.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::PRODUCER_REGS));
    if (tid != L::CONSUMERS || !step_runs(STEP_HANDSHAKE)) return;
    Cursor fill;
    for (int q = 0; q < total; ++q) {
      if (q >= L::RING) bar_wait(&empty[fill.slot], fill.phase ^ 1);
      unsigned char* dst = ring + fill.slot * L::SLOT_BYTES;
      if constexpr (step_runs(STEP_COPIES)) {
        bar_expect_tx(&full[fill.slot], L::SLOT_BYTES);
        const __nv_bfloat16* src = wp + (static_cast<long long>(q) * L::PLANES * npad + n0) * L::PLANE;
        for (int j = 0; j < L::PLANES; ++j)
          bulk_copy(dst + j * L::BN * 16, src + static_cast<long long>(j) * npad * L::PLANE,
                    L::BN * 16, &full[fill.slot]);
      } else {
        bar_arrive(&full[fill.slot]);
      }
      fill.next(L::RING);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CONSUMER_REGS));

  x += v * vstride;
  gx += v * vstride;
  out += v * vstride;
  hprev += v * hstride;
  const int wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // The staging: this thread copies plane `piece` of the staged positions
  // tid / PLANES + i * (CONSUMERS / PLANES); `src` is each one's pixel
  // offset in h_{s-1}, -1 for the zeros of a pad column or outside the image.
  const int piece = tid % L::PLANES;
  int src[L::PER_THREAD];
#pragma unroll
  for (int i = 0; i < L::PER_THREAD; ++i) {
    const int e = tid / L::PLANES + i * (L::CONSUMERS / L::PLANES);
    const int dy = e / L::SEG;
    const int p = m0 + (dy - 1) * WP - 1 + (e - dy * L::SEG);  // padded position
    const int y = p >= 0 ? p / WP : -1, xp = p - y * WP;
    src[i] = e < 3 * L::SEG && p >= 0 && y < H && xp >= 1 && xp <= W ? (y * W + xp - 1) * C : -1;
  }
  auto stage = [&](int chunk) {
    unsigned char* dst = abuf + (chunk & 1) * L::A_BYTES + piece * L::PLANE_BYTES;
    const int c = chunk * L::KC + piece * L::PLANE;
    if constexpr (step_runs(STEP_STAGING))
#pragma unroll
      for (int i = 0; i < L::PER_THREAD; ++i) {
        const int e = tid / L::PLANES + i * (L::CONSUMERS / L::PLANES);
        if (e >= 3 * L::SEG) continue;
        const int dy = e / L::SEG;
        const bool ok = src[i] >= 0 && c < C;
        cp_async16(dst + dy * L::ROW_BYTES + (e - dy * L::SEG) * 16,
                   ok ? hprev + src[i] + c : hprev, ok);
      }
    cp_async_commit();
  };
  stage(0);

  // This thread's accumulator rows r0 and r0 + 8 of the tile as pixels of
  // the image, -1 on a pad column or past the image. Of an m64n256
  // accumulator a thread holds, for each 8 columns j, [4j], [4j + 1] at
  // (row r0, columns 8j + 2t, + 1) and [4j + 2], [4j + 3] at row r0 + 8.
  // gx_s, x_s and h_{s-1} of the rows are asked into L2 now and read after
  // the GEMM, beside the 128 accumulators (the GEMM waits for none of them).
  int pix[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = m0 + wg * 64 + 16 * warp + g + 8 * h;
    const int y = p / WP, xp = p - y * WP;
    pix[h] = p < MP && xp >= 1 && xp <= W ? y * W + xp - 1 : -1;
    // the row's BN channels are 4 lines of 128 bytes: thread t of a quad line t
    const long long line = static_cast<long long>(pix[h]) * C + n0 + 64 * t;
    if (step_runs(STEP_EPILOGUE) && pix[h] >= 0 && n0 + 64 * t < C) {
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(gx + line));
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(x + line));
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(hprev + line));
    }
  }
  float acc[L::BN / 2];
#pragma unroll
  for (int i = 0; i < L::BN / 2; ++i) acc[i] = 0.0f;

  Cursor taken;      // the consumers' place in the ring
  int pending = -1;  // the slot of the wgmma group that may still be in flight
  for (int ch = 0; ch < nchunk; ++ch) {
    cp_async_wait<0>();  // this thread's part of chunk ch landed
    fence_async_smem();  // and is visible to wgmma
    consumers_sync();    // everyone's is
    // A of this warpgroup's 64 rows: tap (dy, dx) starts at tap row dy,
    // position dx; a k16 step is two planes
    const uint64_t da = smem_desc(abuf + (ch & 1) * L::A_BYTES + wg * 64 * 16, L::PLANE_BYTES, 128);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      if (step_runs(STEP_HANDSHAKE)) {
        bar_wait(&full[taken.slot], taken.phase);
        __syncwarp();  // the polls diverge; the wgmma is warp-aligned
      }
      const uint64_t dt = da + (((tap / 3) * L::ROW_BYTES + (tap % 3) * 16) >> 4);
      const uint64_t db = smem_desc(ring + taken.slot * L::SLOT_BYTES, L::BN * 16, 128);
      wgmma_fence();
      if constexpr (step_runs(STEP_MMA))
#pragma unroll
        for (int k = 0; k < L::KC / 16; ++k)
          wgmma_bf16<L::BN>(acc, dt + ((2 * k * L::PLANE_BYTES) >> 4),
                            db + ((2 * k * L::BN * 16) >> 4));
      wgmma_commit();
      wgmma_wait<1>();  // the previous tap's group completed: release its slot
      if (pending >= 0 && step_runs(STEP_HANDSHAKE) && lane == 0) bar_arrive(&empty[pending]);
      pending = taken.slot;
      taken.next(L::RING);
      if (tap == 0 && ch + 1 < nchunk) {
        // every warpgroup's groups of chunk ch - 1 have completed (its last
        // was waited for just now): its buffer takes chunk ch + 1, with no
        // drain of the wgmma pipeline between chunks
        consumers_sync();
        stage(ch + 1);
      }
    }
  }
  wgmma_wait<0>();
  keep(acc);
  if (step_runs(STEP_HANDSHAKE) && lane == 0) bar_arrive(&empty[pending]);

  // Epilogue on the accumulator's own rows and columns, 8 column groups at
  // a time: gate and lerp in f32, one rounding at the store of h_s.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = static_cast<long long>(pix[h]) * C;
#pragma unroll
    for (int j0 = 0; j0 < NJ; j0 += 8) {
      unsigned gr[8], xr[8], hr[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + 8 * (j0 + j) + 2 * t;
        gr[j] = xr[j] = hr[j] = 0u;
        if (!step_runs(STEP_EPILOGUE) || pix[h] < 0 || n >= C) continue;
        gr[j] = __ldg(reinterpret_cast<const unsigned*>(gx + row + n));
        xr[j] = __ldg(reinterpret_cast<const unsigned*>(x + row + n));
        hr[j] = __ldg(reinterpret_cast<const unsigned*>(hprev + row + n));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + 8 * (j0 + j) + 2 * t, i = 4 * (j0 + j) + 2 * h;
        if (pix[h] < 0 || n >= C) continue;
        __nv_bfloat162 o = __floats2bfloat162_rn(acc[i], acc[i + 1]);
        if constexpr (step_runs(STEP_EPILOGUE)) {
          const float2 gv = unpack(gr[j]), xv = unpack(xr[j]), hv = unpack(hr[j]);
          const float g0 = gate(acc[i] + gv.x), g1 = gate(acc[i + 1] + gv.y);
          o = __floats2bfloat162_rn(g0 * xv.x + (1.0f - g0) * hv.x,
                                    g1 * xv.y + (1.0f - g1) * hv.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + row + n) = o;
      }
    }
  }
}

int launch_step_bf16(const void* x, const void* gx, const void* hprev, const void* wp, void* out,
                     long long vstride, long long hstride, int V, int H, int W, int C,
                     void* stream) {
  using L = Bf16Step;
  if (C % L::PLANE) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = allow_smem(twa_step_bf16_kernel, L::SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((H * (W + 2) + L::BM - 1) / L::BM, (C + L::BN - 1) / L::BN, V);
  twa_step_bf16_kernel<<<grid, L::NT, L::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gx),
      static_cast<const __nv_bfloat16*>(hprev), static_cast<const __nv_bfloat16*>(wp),
      static_cast<__nv_bfloat16*>(out), vstride, hstride, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The persistent kernel: one launch per clip (bf16).

// Timing builds only (tools/k1_probe): a bit mask of parts compiled out.
// Such a build computes wrong values; the port never builds one.
#ifndef CLIP_SKIP
#define CLIP_SKIP 0
#endif
enum Part { MMA = 0, LDSM = 1, STAGING = 2, EPILOGUE = 3, ORDER = 4, FENCE = 5, OPERANDS = 6 };
__host__ __device__ constexpr bool runs(Part p) { return !((CLIP_SKIP >> p) & 1); }

constexpr int PN = 32;       // output channels per block: its slice of W_h
constexpr int KC = 32;       // input channels per staged chunk of h_{s-1}
constexpr int MT = 256;      // GEMM rows (pixels) per tile, at most
constexpr int WM = 32;       // GEMM rows per warp: two 16-row mma tiles
constexpr int MI = WM / 16;
constexpr int NTHREAD = MT / WM * 32;  // 8 warps
constexpr int NSTAGE = 3;    // chunk buffers in the cp.async ring
constexpr int ROW_BYTES = KC * 2;   // one staged pixel, and one row of the slice
// Bytes of one staged chunk for a tile of `tr` rows with its halo.
__host__ __device__ constexpr int stage_bytes(int tr, int W) {
  return round_up((tr + 2) * (W + 2), 8) * ROW_BYTES;
}
__host__ __device__ constexpr int clip_smem_bytes(int tr, int W, int C) {
  return 9 * C * ROW_BYTES + NSTAGE * stage_bytes(tr, W) +
         round_up((tr + 2) * (W + 2), 4) * 4;
}

// `ldsm` loads four 8x8 b16 matrices from shared memory: lane l gives the
// shared-space address of row l % 8 of matrix l / 8 and receives, of matrix i, the two
// elements (row l / 4, columns 2 * (l % 4) and + 1) in r[i]; `.trans` hands
// out the transposed matrices, which turns a (k, n) tile into the mma's B.
__device__ __forceinline__ void ldsm(unsigned (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_trans(unsigned (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// c (16x8, f32) += a (16x16, bf16, row-major) . b (16x8, bf16). With
// g = l / 4, t = l % 4: c[0], c[1] are (row g, columns 2t, 2t + 1) and
// c[2], c[3] the same columns of row g + 8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Byte offset of 16-byte chunk `q` (of 4) in row `row` of a swizzled array
// of 64-byte rows: rows 2 apart swap chunk pairs, so 8 consecutive rows put
// one chunk each on 8 distinct 16-byte bank groups.
__device__ __forceinline__ int swz(int row, int q) {
  return row * ROW_BYTES + ((q ^ ((row >> 1) & 3)) << 4);
}

// grid = groups * (C / PN) blocks: block b owns channel slice b % (C / PN)
// and the tiles b / (C / PN), + groups, ... of the V * ceil(H / TR) tiles.
// `done[tile]` counts the slice blocks that have stored the tile's h_s, over
// all frames so far; the wrapper zeroes it. TR = clip_tile_rows(H, W, C).
__global__ void __launch_bounds__(NTHREAD, 1)
    twa_clip_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ gx,
                    const __nv_bfloat16* h0, const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* ys, int* done, int V, int S, int H, int W,
                    int C, int TR) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Ws = smem;
  const int sbytes = stage_bytes(TR, W);
  unsigned char* stage = smem + 9 * C * ROW_BYTES;
  int* table = reinterpret_cast<int*>(stage + NSTAGE * sbytes);
  const unsigned ws_a = static_cast<unsigned>(__cvta_generic_to_shared(Ws));
  const unsigned stage_a = static_cast<unsigned>(__cvta_generic_to_shared(stage));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lrow = lane % 16, lhalf = lane / 16;
  const unsigned b_lane = swz(lrow, lhalf);  // this lane's row and chunk of a B tile
  const int nslice = C / PN, groups = gridDim.x / nslice;
  const int n0 = (blockIdx.x % nslice) * PN;
  const int tiles = (H + TR - 1) / TR, total = V * tiles;
  const int PW = W + 2, nchunk = C / KC;
  const long long hwc = static_cast<long long>(H) * W * C;

  // The block's slice of W_h, resident for the whole clip. Its columns are
  // stored permuted, pair (4a + b) of the 16 channel pairs at pair (4b + a):
  // an mma hands lane t of a quad columns 2t, 2t + 1 of each of the four
  // 8-column blocks, and with this order those are the 8 consecutive
  // channels 8t .. 8t + 7, one 16-byte access per row in the epilogue.
  for (int i = tid; i < 9 * C * (PN / 2); i += NTHREAD) {
    const int k = i / (PN / 2), pa = i % (PN / 2);
    const int ps = (pa % 4) * 4 + pa / 4;
    *reinterpret_cast<unsigned*>(Ws + swz(k, ps / 4) + (ps % 4) * 4) =
        __ldg(reinterpret_cast<const unsigned*>(w + static_cast<long long>(k) * C + n0) + pa);
  }

  for (int s = 0; s < S; ++s) {
    for (int mt = blockIdx.x / nslice; mt < total; mt += groups) {
      const int v = mt / tiles, t = mt - v * tiles;
      const int y0 = t * TR, rows = min(TR, H - y0);
      const int mrows = rows * W, npix = (rows + 2) * PW;
      const bf16* hp = s == 0 ? h0 + v * hwc
                              : ys + (static_cast<long long>(v) * S + s - 1) * hwc;

      // element offset of every staged pixel in the image, -1 for the zero
      // halo outside it (other videos' pixels are never read)
      for (int i = tid; i < npix; i += NTHREAD) {
        const int ry = i / PW, rx = i - ry * PW;
        const int y = y0 - 1 + ry, xx = rx - 1;
        table[i] = (y >= 0 && y < H && xx >= 0 && xx < W) ? (y * W + xx) * C : -1;
      }
      // frame s - 1 of this tile and of its row neighbours must be stored
      if (runs(ORDER) && s > 0 && tid < 3) {
        const int tt = t - 1 + tid;
        if (tt >= 0 && tt < tiles) {
          const int* flag = done + v * tiles + tt;
          while (load_acquire(flag) < nslice * s) __nanosleep(40);
        }
      }
      __syncthreads();

      auto stage_chunk = [&](int chunk) {
        unsigned char* dst = stage + (chunk % NSTAGE) * sbytes;
        const bf16* src = hp + chunk * KC;
        if constexpr (!runs(STAGING)) return;
        for (int i = tid; i < npix * 4; i += NTHREAD) {
          const int p = i >> 2, q = i & 3;
          const int off = table[p];
          cp_async16(dst + swz(p, q), src + max(off, 0) + q * 8, off >= 0);
        }
      };

      // staged pixel of each ldmatrix row this lane addresses, centre tap
      int pc[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = min(warp * WM + i * 16 + lrow, mrows - 1);
        const int ry = r / W;
        pc[i] = (ry + 1) * PW + (r - ry * W) + 1;
      }

      float acc[MI][4][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
      for (int st = 0; st < NSTAGE - 1; ++st) {
        if (st < nchunk) stage_chunk(st);
        cp_async_commit();
      }

      // The epilogue's operands for this thread's accumulator rows and
      // columns (GEMM row r of the tile is pixel y0 * W + r of the image),
      // asked for now, behind the first chunks, so that they arrive while the
      // GEMM runs.
      const long long frame = (static_cast<long long>(v) * S + s) * hwc;
      const long long pix0 = static_cast<long long>(y0) * W * C + n0 + (lane % 4) * 8;
      uint4 xr[MI][2], gr[MI][2], hr[MI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp * WM + i * 16 + lane / 4 + half * 8;
          if (!runs(EPILOGUE) || r >= mrows) continue;
          const long long off = pix0 + static_cast<long long>(r) * C;
          if constexpr (!runs(OPERANDS)) {
            xr[i][half] = gr[i][half] = hr[i][half] = make_uint4(tid, 0, r, 1);
            continue;
          }
          xr[i][half] = __ldg(reinterpret_cast<const uint4*>(x + frame + off));
          gr[i][half] = __ldg(reinterpret_cast<const uint4*>(gx + frame + off));
          // another block of this launch may have written it: L2 only
          hr[i][half] = __ldcg(reinterpret_cast<const uint4*>(hp + off));
        }

      for (int ch = 0; ch < nchunk; ++ch) {
        cp_async_wait<NSTAGE - 2>();  // this thread's part of chunk ch landed
        __syncthreads();              // everyone's did, and chunk ch - 1 is used up
        if (ch + NSTAGE - 1 < nchunk) stage_chunk(ch + NSTAGE - 1);
        cp_async_commit();
        // 18 K steps (9 taps x 2 halves of the chunk), the fragments of
        // step k + 1 loaded while step k multiplies
        const unsigned A = stage_a + (ch % NSTAGE) * sbytes;
        const unsigned B = ws_a + ch * (KC * ROW_BYTES) + b_lane;
        unsigned a[2][MI][4], b[2][2][4];
        if constexpr (!runs(LDSM)) {
          for (int i = 0; i < 2 * MI * 4; ++i) (&a[0][0][0])[i] = tid;
          for (int i = 0; i < 16; ++i) (&b[0][0][0])[i] = tid;
        }
        auto load = [&](int k, unsigned (&fa)[MI][4], unsigned (&fb)[2][4]) {
          const int tap = k / 2, kk = k % 2;
          const int shift = (tap / 3 - 1) * PW + (tap % 3 - 1);
          // rows tap * C + ch * KC + kk * 16 + lrow of the slice: all but
          // lrow are multiples of 16, so the swizzle sees lrow only
          const unsigned bt = B + (tap * C + kk * 16) * ROW_BYTES;
          if constexpr (!runs(LDSM)) return;
          ldsm_trans(fb[0], bt);
          ldsm_trans(fb[1], bt ^ 32);  // chunks 2, 3: the pair's other half
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            const int p = pc[i] + shift;
            ldsm(fa[i], (A + p * ROW_BYTES + ((lhalf ^ ((p >> 1) & 3)) << 4)) ^ (kk * 32));
          }
        };
        load(0, a[0], b[0]);
#pragma unroll
        for (int k = 0; k < 18; ++k) {
          if (k + 1 < 18) load(k + 1, a[(k + 1) & 1], b[(k + 1) & 1]);
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if constexpr (!runs(MMA)) continue;
              mma_bf16(acc[i][2 * j], a[k & 1][i], b[k & 1][j][0], b[k & 1][j][1]);
              mma_bf16(acc[i][2 * j + 1], a[k & 1][i], b[k & 1][j][2], b[k & 1][j][3]);
            }
        }
      }

      // Epilogue on the accumulator's own rows and columns, straight from
      // registers: gate and lerp in f32, one rounding at the store of h_s.
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp * WM + i * 16 + lane / 4 + half * 8;
          if (!runs(EPILOGUE) || r >= mrows) continue;
          const long long off = pix0 + static_cast<long long>(r) * C;
          const unsigned* xs = reinterpret_cast<const unsigned*>(&xr[i][half]);
          const unsigned* gs = reinterpret_cast<const unsigned*>(&gr[i][half]);
          const unsigned* hs = reinterpret_cast<const unsigned*>(&hr[i][half]);
          uint4 out;
          __nv_bfloat162* os = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // channels 2j, 2j + 1 of the lane's 8
            const float2 xv = unpack(xs[j]), gv = unpack(gs[j]), hv = unpack(hs[j]);
            const float g0 = gate(acc[i][j][half * 2] + gv.x);
            const float g1 = gate(acc[i][j][half * 2 + 1] + gv.y);
            os[j] = __floats2bfloat162_rn(g0 * xv.x + (1.0f - g0) * hv.x,
                                          g1 * xv.y + (1.0f - g1) * hv.y);
          }
          *reinterpret_cast<uint4*>(ys + frame + off) = out;
        }
      if constexpr (runs(FENCE)) __threadfence();   // h_s is visible to the card before the count moves
      __syncthreads();   // and the stage buffers and the table are free again
      if (tid == 0) {
        if constexpr (runs(FENCE)) __threadfence();  // cumulative: orders what the barrier made visible
        atomicAdd(done + mt, 1);
      }
    }
  }
  cp_async_wait<0>();
}

// Image rows per tile: the most that give at most MT GEMM rows and fit,
// with their one-pixel halo, beside the W_h slice; 0 when C is not a
// multiple of PN or not even one row fits (the per-frame kernel's shapes).
int clip_tile_rows(int H, int W, int C) {
  if (H < 1 || W < 1 || C < PN || C % PN) return 0;
  for (int tr = min(H, MT / W); tr >= 1; --tr)
    if (clip_smem_bytes(tr, W, C) <= SMEM_LIMIT) return tr;
  return 0;
}

// The blocks of the persistent kernel that are resident at once on the
// current device with `smem` bytes of dynamic shared memory each. The host
// queries behind it (the shared-memory attribute, the SM count, the
// occupancy) run once per device and size, at the first launch, so that a
// launch captured into a CUDA graph (serving/steps.py::graph_step, whose
// warm-up makes that first launch) is the launch alone.
cudaError_t clip_resident_blocks(int smem, int* resident) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, int> known;  // (device, smem) -> blocks
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find({device, smem});
  if (it != known.end()) {
    *resident = it->second;
    return cudaSuccess;
  }
  if ((err = allow_smem(twa_clip_kernel, smem)) != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, twa_clip_kernel,
                                                           NTHREAD, smem)) != cudaSuccess)
    return err;
  *resident = known[{device, smem}] = per_sm * sms;
  return cudaSuccess;
}

int launch_clip(const void* x, const void* gx, const void* h0, const void* w,
                void* ys, void* done, int V, int S, int H, int W, int C,
                void* stream) {
  int TR = clip_tile_rows(H, W, C);
  if (TR < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = clip_smem_bytes(TR, W, C);
  int resident = 0;
  cudaError_t err = clip_resident_blocks(smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every block must be resident: its waits are on other blocks' progress
  const int nslice = C / PN, total = V * ((H + TR - 1) / TR);
  const int groups = min(total, resident / nslice);
  if (groups < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&x, &gx, &h0, &w, &ys, &done, &V, &S, &H, &W, &C, &TR};
  // a cooperative launch through the launch-attribute API, which a stream
  // capture records as a cooperative kernel node
  cudaLaunchAttribute cooperative[1];
  cooperative[0].id = cudaLaunchAttributeCooperative;
  cooperative[0].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(groups * nslice);
  config.blockDim = dim3(NTHREAD);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = cooperative;
  config.numAttrs = 1;
  err = cudaLaunchKernelExC(&config, reinterpret_cast<const void*>(twa_clip_kernel), args);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() right after the launch (0 on success).
// `w_packed` is W_h packed by ops/twa.py::pack_twa_weights_bf16.
int twa_step_bf16(const void* x, const void* gx, const void* hprev,
                  const void* w_packed, void* out, long long vstride,
                  long long hstride, int V, int H, int W, int C,
                  void* stream) {
  return launch_step_bf16(x, gx, hprev, w_packed, out, vstride, hstride, V, H, W, C, stream);
}

// `w_packed` is W_h packed by ops/twa.py::pack_twa_weights.
int twa_step_f32(const void* x, const void* gx, const void* hprev,
                 const void* w_packed, void* out, long long vstride,
                 long long hstride, int V, int H, int W, int C,
                 void* stream) {
  return launch_step_f32(x, gx, hprev, w_packed, out, vstride, hstride, V, H, W, C, stream);
}

// The packed-weight layout the f32 kernel reads, for the pack to be held
// against: input channels per chunk (one tap of a chunk per ring slot),
// output channels per block, channels per k step and per plane.
void twa_f32_layout(int* chunk, int* column_block, int* k_step, int* plane) {
  *chunk = F32Step::KC;
  *column_block = F32Step::BN;
  *k_step = F32Step::KSTEP;
  *plane = F32Step::PLANE;
}

// The packed-weight layout the bf16 per-frame kernel reads, for the pack to
// be held against: input channels per chunk (C is padded to it), output
// channels per block (N is padded to it), channels per plane.
void twa_bf16_layout(int* chunk, int* columns, int* plane) {
  *chunk = Bf16Step::KC;
  *columns = Bf16Step::BN;
  *plane = Bf16Step::PLANE;
}

// The whole clip in one cooperative launch (bf16). `done` is a zeroed int32
// scratch of V * ceil(H / twa_clip_tile_rows(H, W, C)) entries. Returns the launch's error code (0 on
// success): a grid that cannot be resident at once is refused, never hung.
int twa_scan_bf16(const void* x, const void* gx, const void* h0, const void* w,
                  void* ys, void* done, int V, int S, int H, int W, int C,
                  void* stream) {
  return launch_clip(x, gx, h0, w, ys, done, V, S, H, W, C, stream);
}

// The persistent kernel's tile height in image rows at this frame size, 0
// where it does not take the shape.
int twa_clip_tile_rows(int H, int W, int C) { return clip_tile_rows(H, W, C); }

const char* twa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
