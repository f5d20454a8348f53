// Hopper's pieces for the tensor-core stages of junction.cu and
// encoder_head.cu: wgmma with A from registers, the weights' 128-byte-swizzled
// layout in shared memory, a ring of weight slots filled by bulk copies that
// complete on mbarriers, and the encoder's conv1_2 + ReLU + 2x2 max pool built
// on them, which both kernels run (conv1_2_pool). ns_sqrtm.cu and
// centered_gram.cu take the tf32 product in its SS form (wgmma_tf32_ss: A
// from shared memory too, through the same descriptor), with the same
// partials and folds; conv3x3_small.cu the bf16 one (wgmma_bf16_ss, N = 64 or
// 8), A a tap's shifted window of its TMA-staged tile, whose descriptor may
// start at any pixel (the swizzle follows the address bits).
//
// wgmma, RS form. A warpgroup (4 warps, 128 threads) issues
// wgmma.mma_async.m64n64k{16 bf16, 8 tf32}: D [64 x 64] f32 += A [64 x K] .
// B [K x 64]. A comes from registers, each warp holding 16 of the 64 rows in
// mma.sync's A fragment layout, so the rows are whatever pixels a warp loads:
// a tap's shifted window, read through the upsample tables or by ldmatrix
// from any 16 pixels, costs nothing, and a 64-row block is the four warps'
// m-tiles. D comes back in mma.sync's accumulator layout, per warp. B (one
// k-step of a 64->64 conv's weights) is read from shared memory through a
// descriptor: K-major rows of 128 bytes (64 bf16 or 32 tf32 input channels
// of one output channel), eight rows to a 1 KB swizzle atom, the 16-byte
// column chunk c of row r stored at chunk c ^ (r % 8). The host writes that
// layout once (ops/junction.py::_wgmma_weights), so a chunk of weights is one
// contiguous run of bytes; a k-step starts 32 bytes further along the rows.
//
// Accuracy. The tensor cores truncate their own sums, so a sum over a whole
// conv in one accumulator drifts toward zero (conv_tc.cuh). Each group of
// wgmma's (kFoldSteps k-steps of one chunk; f32: its three 3xTF32 products
// each) opens a fresh partial with scale-d = 0, and once the group is done
// (wgmma.wait_group) the partial is folded into the running f32 sum with a
// rounded add. junction.cu folds every 4 k-steps in f32 (32 channels) and
// every 2 in bf16 (32 channels): bf16 partials of 64 channels flipped
// enough roundings to fail its float64 bars (PERF.md).
//
// The weight ring. kS slots (16 KB, or a bf16 chunk's 8 KB), each with a
// "full" mbarrier. One thread arms a slot's barrier with the chunk's byte
// count and issues the bulk copy (cp.async.bulk, global -> shared,
// contiguous); the consumers
// wait on the barrier's phase. There is no block barrier per chunk and no
// producer warp: once a warpgroup's wgmma's have read a slot (wait_group
// returned), the warpgroup meets at a named barrier and its first thread
// counts it out with a shared-memory atomic; the second warpgroup out
// refills the slot with the chunk kS positions on. A release costs thread 0
// about 250 cycles a chunk, most of it waiting for the warpgroup's other
// warps (stage stamps); each warp counting itself out cost the same. Tried
// and dropped (PERF.md): "empty" mbarriers with thread 0 alone refilling
// (no cost at release, but the refills came late and the waits for weights
// grew sixfold). A producer warp would wait on those same barriers, but the
// 256 consumer threads already hold up to 255 registers each (one block per
// SM), so it could have none of its own without setmaxnreg, and that would
// take named barriers in the FFMA stages. encoder_head.cu runs the ring on
// across its tiles, or (bf16) holds all nine taps and never refills it.

#pragma once
#include "conv_tc.cuh"

namespace wct {

// ----------------------------------------------------- mbarrier, bulk copy

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more of asynchronous copies.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) global -> shared;
// completes on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Order this thread's (and, after a barrier, the block's) earlier shared
// memory accesses before later asynchronous-proxy ones (the bulk copies).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------ wgmma

// The descriptor of a K-major, 128-byte-swizzled B operand at shared address
// `addr`: 8-row atoms 1,024 bytes apart (SBO), the leading offset unused.
// Atoms start 1 KB-aligned; a k-step inside the atom adds its byte offset.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of these registers across the
// wgmma's asynchronous reads and writes.
template <int NA>
__device__ __forceinline__ void fence_regs(float (&r)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WCT_D32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WCT_D32_OUT(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d = (scale_d ? d : 0) + A . B, bf16 operands, K = 16; B K-major (no transpose).
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WCT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WCT_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d = (scale_d ? d : 0) + A . B, bf16 operands, K = 16, both from shared
// memory through descriptors (A's may start anywhere 16-byte aligned inside
// a swizzle atom: the swizzle follows the address bits).
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[32], uint64_t adesc, uint64_t bdesc,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WCT_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WCT_D32_OUT(d)
      : "l"(adesc), "l"(bdesc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[4], uint64_t adesc, uint64_t bdesc,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}"
      ", %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(adesc), "l"(bdesc), "r"(scale_d));
}

// d = (scale_d ? d : 0) + A . B, tf32 operands (f32 bit patterns), K = 8.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WCT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WCT_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}


// d = (scale_d ? d : 0) + A . B, tf32 operands, K = 8, both from shared memory:
// A [64 x 8] and B [64 x 8] K-major, each through a desc_sw128 descriptor.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t adesc, uint64_t bdesc,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WCT_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : WCT_D32_OUT(d)
      : "l"(adesc), "l"(bdesc), "r"(scale_d));
}

// Order this thread's earlier generic-proxy accesses of global memory before
// later asynchronous-proxy ones (bulk copies reading what it wrote).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

template <int NA>
__device__ __forceinline__ void fold(float (&acc)[NA], float (&part)[NA]) {
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] += part[i];
}

__device__ __forceinline__ void load_a(uint32_t (&a)[kStepsPerChunk][4], uint32_t addr) {
#pragma unroll
  for (int j = 0; j < kStepsPerChunk; ++j) ldsm_x4(addr + 32 * j, a[j][0], a[j][1], a[j][2], a[j][3]);
}

// bf16: acc[rb] += the chunk at `slot` (kStepsPerChunk k-steps of 16
// channels; B 64 rows of 128 bytes, one tap) times the A rows of the
// warpgroup's row block rb, for its NRB blocks. a[0] holds row block 0's A
// on entry; a_addr(rb) is the lane's ldmatrix address of k-step 0 (k-step j
// 32 bytes on). One partial per kFoldSteps k-steps; the groups run back to
// back: while group i's wgmma's run, group i - 1's partial is folded and the
// next block's A is read (registers: two partials, two blocks' A). Before
// the chunk drains, the next chunk's first A is read into a[0] from
// `next_a0` (0: none). The chunk ends drained (wait_group 0): with wgmma's
// in flight across the chunk loop's back edge, ptxas cannot tell the
// partial being folded from the one being written and serializes every
// wgmma (its warning C7514), and unrolling the chunks instead spills.
template <int NRB, int kFoldSteps, typename AAddr>
__device__ __forceinline__ void chunk_rows(float (&acc)[NRB][32], uint32_t (&a)[2][kStepsPerChunk][4],
                                           uint32_t slot, AAddr a_addr, uint32_t next_a0) {
  static_assert(kStepsPerChunk % kFoldSteps == 0, "a partial never spans two chunks");
  constexpr int kG = kStepsPerChunk / kFoldSteps;  // groups per row block
  static_assert(NRB % 2 == 0, "the next chunk's first A goes where row block NRB - 2's was");
  float part[2][32];
#pragma unroll
  for (int i = 0; i < NRB * kG; ++i) {
    const int rb = i / kG, j0 = (i % kG) * kFoldSteps;
    wgmma_fence();
#pragma unroll
    for (int j = j0; j < j0 + kFoldSteps; ++j)
      wgmma_bf16(part[i & 1], a[rb & 1][j], desc_sw128(slot + 32 * j), j > j0);
    wgmma_commit();
    if (i > 0) {
      wgmma_wait<1>();  // group i - 1, and so every group of block rb - 1
      fold(acc[(i - 1) / kG], part[(i - 1) & 1]);
    }
    if (i % kG == 0) {
      if (rb + 1 < NRB)
        load_a(a[(rb + 1) & 1], a_addr(rb + 1));
      else if (next_a0 != 0)
        load_a(a[0], next_a0);
    }
  }
  wgmma_wait<0>();
  fold(acc[NRB - 1], part[(NRB * kG - 1) & 1]);
}

// f32 in 3xTF32: acc[rb] += the chunk at `slot` (4 k-steps of 8 input
// channels; B's hi, 8 KB of 64 rows of 32 channels, then its lo) times the
// A rows of row block rb, for the warpgroup's NRB blocks. a_at(rb, j, ah, al)
// gathers k-step j's fragment split into hi and lo. Per k-step lo.hi, hi.lo,
// then hi.hi, the small products first, as conv_tc.cuh. A group is half a
// chunk (2 k-steps, 6 wgmma's); row block rb's two groups sum into partial
// rb % 2. While a group runs, the previous block's partial is folded and the
// next group's A is gathered (registers: two partials, two half-chunks of
// A). With a finer kFoldSteps each row block's partials run one after
// another instead.
template <int NRB, int kFoldSteps, typename AAt>
__device__ __forceinline__ void chunk_rows_tf32(float (&acc)[NRB][32], uint32_t slot, AAt a_at) {
  static_assert(kStepsPerChunk % kFoldSteps == 0, "a partial never spans two chunks");
  constexpr int kH = kStepsPerChunk / 2;  // k-steps per group
  uint32_t ah[2][kH][4], al[2][kH][4];
  float part[2][32];
  if constexpr (kFoldSteps < kStepsPerChunk) {
#pragma unroll
    for (int rb = 0; rb < NRB; ++rb)
#pragma unroll
      for (int j0 = 0; j0 < kStepsPerChunk; j0 += kFoldSteps) {
#pragma unroll
        for (int j = j0; j < j0 + kFoldSteps; ++j) a_at(rb, j, ah[0][j - j0], al[0][j - j0]);
        wgmma_fence();
#pragma unroll
        for (int j = j0; j < j0 + kFoldSteps; ++j) {
          wgmma_tf32(part[0], al[0][j - j0], desc_sw128(slot + 32 * j), j > j0);
          wgmma_tf32(part[0], ah[0][j - j0], desc_sw128(slot + 8192 + 32 * j), 1);
          wgmma_tf32(part[0], ah[0][j - j0], desc_sw128(slot + 32 * j), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fold(acc[rb], part[0]);
      }
    return;
  }
#pragma unroll
  for (int rb = 0; rb < NRB; ++rb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // Buffer h last fed group (rb - 1, h), done since the last wait.
#pragma unroll
      for (int jj = 0; jj < kH; ++jj) a_at(rb, kH * h + jj, ah[h][jj], al[h][jj]);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < kH; ++jj) {
        const int j = kH * h + jj;
        wgmma_tf32(part[rb & 1], al[h][jj], desc_sw128(slot + 32 * j), j > 0);
        wgmma_tf32(part[rb & 1], ah[h][jj], desc_sw128(slot + 8192 + 32 * j), 1);
        wgmma_tf32(part[rb & 1], ah[h][jj], desc_sw128(slot + 32 * j), 1);
      }
      wgmma_commit();
      if (rb > 0 || h > 0) wgmma_wait<1>();  // the group before this one
      if (h == 0 && rb > 0) fold(acc[rb - 1], part[(rb - 1) & 1]);
    }
  wgmma_wait<0>();
  fold(acc[NRB - 1], part[(NRB - 1) & 1]);
}

// ---------------------------------------------------------------- the ring

// A kernel's weights in stream order: n_a chunks of a first 64->64 conv, one
// chunk of the small stages' weights (s0, then s1; float counts multiples of
// 4), n_b chunks of a second 64->64 conv.
struct WeightStream {
  const unsigned char* a;
  int n_a;
  const float* s0;
  int n_s0;
  const float* s1;
  int n_s1;
  const unsigned char* b;
  int n_b;
};

// kS slots of kSlotBytes (1 KB-aligned), each with a "full" barrier (armed
// with its bytes, completed by the bulk copy) and a count of the
// warpgroups done with its current chunk. Stream position q lives in slot q %
// kS; its use of the slot is the (q / kS)-th.
template <int kS, int kSlotBytes = 16384>
struct Ring {
  unsigned char* slots;
  uint64_t* full;
  int* done;

  __device__ __forceinline__ uint32_t slot(int q) const {
    return smem_addr(slots + (q % kS) * kSlotBytes);
  }

  // Thread 0: the barriers, before any copy.
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < kS; ++s) {
      mbar_init(smem_addr(full + s), 1);
      done[s] = 0;
    }
  }

  // One thread: `bytes` from src into position q's slot, on its barrier.
  __device__ __forceinline__ void copy(int q, const void* src, uint32_t bytes) const {
    const uint32_t bar = smem_addr(full + q % kS);
    mbar_expect_tx(bar, bytes);
    bulk_copy(slot(q), src, bytes, bar);
  }

  // One thread: put stream position q of `ws` in flight into its slot; past
  // the stream's end, nothing. A slot that held the small stages' weights
  // was read by ordinary loads (the block's, ordered before this thread by a
  // barrier), not by wgmma's asynchronous reads: fence those before the
  // copy's writes.
  template <int kChunkBytes>
  __device__ __forceinline__ void issue(int q, const WeightStream& ws) const {
    if (q - kS == ws.n_a) fence_proxy_async();
    if (q < ws.n_a) {
      copy(q, ws.a + (size_t)q * kChunkBytes, kChunkBytes);
    } else if (q == ws.n_a) {
      const uint32_t bar = smem_addr(full + q % kS), dst = slot(q);
      const uint32_t n0 = ws.n_s0 * 4, n1 = ws.n_s1 * 4;
      mbar_expect_tx(bar, n0 + n1);
      bulk_copy(dst, ws.s0, n0, bar);
      bulk_copy(dst + n0, ws.s1, n1, bar);
    } else if (q - ws.n_a - 1 < ws.n_b) {
      copy(q, ws.b + (size_t)(q - ws.n_a - 1) * kChunkBytes, kChunkBytes);
    }
  }

  // Every thread that reads position q: wait until it has arrived.
  __device__ __forceinline__ void wait(int q) const {
    mbar_wait(smem_addr(full + q % kS), (q / kS) & 1);
  }

  // Every thread of a warpgroup, once the warpgroup's wgmma's have read
  // position q: the warpgroup meets at its named barrier (1 or 2; 0 is
  // __syncthreads') and its first thread counts it out of the slot; the
  // second warpgroup out calls refill(q + kS), which may put that position in
  // flight (ring.copy).
  template <typename Refill>
  __device__ __forceinline__ void release(int q, Refill refill) const {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (int)(threadIdx.x >> 7)) : "memory");
    if ((threadIdx.x & 127) == 0 && (atomicAdd(done + q % kS, 1) & 1) == 1) refill(q + kS);
  }

  template <int kChunkBytes>
  __device__ __forceinline__ void release(int q, const WeightStream& ws) const {
    release(q, [&](int p) { issue<kChunkBytes>(p, ws); });
  }
};

// ------------------------------------------------------ conv1_2 + pool

// k-steps per partial: 32 input channels in both forms (a bf16 partial of 64
// failed the junction's float64 bars; PERF.md).
template <typename T>
constexpr int kFoldSteps = is_f32<T>() ? 4 : 2;

// The A fragment of k-step j of chunk c for the lane's rows of one row block:
// f32 the 4 values at rows off[0], off[1] (map pixels), channels ch + t,
// ch + t + 4 of planes `plane` floats apart, split into hi and lo.
__device__ __forceinline__ void a_tf32(const float* p, int plane, const int (&off)[2],
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float a = p[(e >> 1) * 4 * plane + off[e & 1]];
    ah[e] = to_tf32(a);
    al[e] = to_tf32(a - __uint_as_float(ah[e]));
  }
}

// e1 [(8 kRB + 2) x 18] (halo fixed) -> relu(conv1_2) on the (8 kRB) x 16 tile
// -> 2x2 max pool, each pooled value handed to store(r, x, c, v): pooled row r
// (0 .. 4 kRB - 1) and column x (0 .. 7) of the tile, channel c; each once,
// by one lane. Warp w owns tile rows kRB w .. kRB w + kRB - 1, one
// 16-pixel slice each; slice rb of the four warps is the warpgroup's row block
// rb (M = 64), so a chunk's B feeds kRB row blocks. conv1_2's chunk c is ring
// position q0 + c: wait(q) before its wgmma's, release(q) after them; slot(q)
// its shared address. The pool's vertical max is between slices 2p and 2p + 1
// in registers, its horizontal max one shuffle away (lane ^ 4). Under bf16 the
// max of the rounded values is the rounded max.
template <typename T, int kRB, typename Slot, typename Wait, typename Release, typename Store>
__device__ __forceinline__ void conv1_2_pool(const T* e1, int q0, Slot slot, Wait wait,
                                             Release release, const float* __restrict__ be2,
                                             Store store) {
  constexpr int kChunks = Tc<T>::kChunks, kPerTap = kChunks / 9;
  constexpr int kPlane = (8 * kRB + 2) * kE1S;  // e1's pixels
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[kRB][32];
#pragma unroll
  for (int rb = 0; rb < kRB; ++rb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[rb][i] = 0.f;
  if constexpr (is_f32<T>()) {
    for (int c = 0; c < kChunks; ++c) {
      const int q = q0 + c, tap = c / kPerTap, dy = tap / 3, dx = tap % 3;
      const int ch0 = (c % kPerTap) * kStepsPerChunk * Tc<T>::kKStep;
      wait(q);
      chunk_rows_tf32<kRB, kFoldSteps<T>>(acc, slot(q),
                                          [&](int rb, int j, uint32_t(&ah)[4], uint32_t(&al)[4]) {
                                            const int row = kRB * warp + rb + dy;  // e1 row of the slice
                                            const int off[2] = {row * kE1S + g + dx,
                                                                row * kE1S + g + 8 + dx};
                                            a_tf32(e1 + (ch0 + 8 * j + t) * kPlane, kPlane, off,
                                                   ah, al);
                                          });
      release(q);
    }
  } else {  // a chunk is a tap
    const uint32_t a_base =
        smem_addr(e1 + (kRB * warp * kE1S + (lane & 15)) * kPitch + 8 * (lane >> 4));
    const auto row_at = [&](int c, int rb) {
      return a_base + ((rb + c / 3) * kE1S + c % 3) * kPitch * 2;
    };
    uint32_t a[2][kStepsPerChunk][4];
    load_a(a[0], row_at(0, 0));
    for (int c = 0; c < kChunks; ++c) {
      const int q = q0 + c;
      wait(q);
      chunk_rows<kRB, kFoldSteps<T>>(acc, a, slot(q), [&](int rb) { return row_at(c, rb); },
                                     c + 1 < kChunks ? row_at(c + 1, 0) : 0u);
      release(q);
    }
  }
  // acc[rb][4 nt + e]: tile row kRB warp + rb, column g + 8 (e >> 1), channel
  // 8 nt + 2 t + (e & 1).
#pragma unroll
  for (int p = 0; p < kRB / 2; ++p)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bias = __ldg(be2 + 8 * nt + 2 * t + (e & 1));
        float v = fmaxf(fmaxf(acc[2 * p][4 * nt + e] + bias, 0.f),
                        fmaxf(acc[2 * p + 1][4 * nt + e] + bias, 0.f));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
        if ((g & 1) == 0)
          store((kRB / 2) * warp + p, (g >> 1) + 4 * (e >> 1), 8 * nt + 2 * t + (e & 1), v);
      }
}

}  // namespace wct
