// Smith-Waterman / Gotoh single-pair score fill for NVIDIA Hopper (sm_90a),
// called from JAX through the XLA foreign function interface.
//
// Layout. The (n x m) DP matrix is cut into horizontal stripes of 32*R rows;
// one warp owns one stripe at a time. Lane k holds rows [k*R, k*R+R) of the
// stripe in registers and, at step t, computes column c = t - k for all of
// them, so the warp sweeps its stripe along anti-diagonals:
//
//   * UP / F inflow of lane k's first row is lane k-1's last row at the same
//     column, computed one step earlier: one __shfl_up_sync per step;
//   * lane 0's inflow is the bottom row of the stripe above, which that
//     stripe's lane 31 streams to global memory (it stays in L2) and
//     publishes in 32-column chunks through a per-stripe progress flag.
//     Boundary rows live in a ring of `slots` rows: stripe s overwrites
//     column x of the row stripe s-2 wrote only after stripe s-1 has read
//     it (s reaches x only after s-1 has published x + 31, which it does
//     only after loading its own inflow up to x + 62), so two slots are
//     enough and memory stays O(m) whatever the matrix height;
//   * the query `a` streams through the warp as a shift register; the
//     stripe's target rows are fixed per lane.
//
// Stripes advance as a block wavefront: stripe s trails stripe s-1 by about
// 64 columns, so every stripe of the matrix is in flight once the ramp has
// filled. The grid is persistent (at most one resident wave of blocks) and
// each warp walks stripes s, s + W, s + 2W, ... in increasing order, so a
// warp only ever waits on a stripe whose owner is running: no deadlock.
//
// Each lane keeps, per row, the first column reaching that row's maximum;
// the warp reduces them once per stripe under the row-major first-occurrence
// rule and writes (score, i, j) for the stripe. The reduction across
// stripes, the input padding and the substitution-table embedding happen in
// JAX (swtpu/kernels/gpu_fill.py). All arithmetic is int32, exact.

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kNeg = -(1 << 30);
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int m;          // columns (length of a)
  int n;          // rows (length of b)
  int stripes;    // ceil(n / (32 R))
  int mpad;       // m rounded up to 32: row stride of the boundary buffers
  int slots;      // rows in the boundary ring (>= 2 when stripes > 1)
  int match;
  int mismatch;
  int gap_open;   // linear mode: the gap penalty
  int gap_extend;
  int sub_dim;    // A + 3 in substitution mode, else 0
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// (score, i, j) ordering: higher score first, then smaller row, then
// smaller column (first occurrence in row-major order).
__device__ __forceinline__ bool better(int s, int i, int j,
                                       int bs, int bi, int bj) {
  return s > bs || (s == bs && s > 0 && (i < bi || (i == bi && j < bj)));
}

template <int R, bool AFFINE, bool SUB>
struct Stripe {
  const Params p;
  const int8_t* __restrict__ a;
  const int* __restrict__ sub;      // shared-memory table (SUB)
  int* __restrict__ bound_h;
  int* __restrict__ bound_f;
  int* __restrict__ flags;
  int* __restrict__ right;
  int s, lane, row0;
  int64_t base;                     // ring row this stripe writes
  int64_t above;                    // ring row of the stripe above

  int bcode[R];
  int h[R], e[R], bs[R], bj[R];
  int bot_h, bot_f, diag_top, a_cur;
  int chunk_h, chunk_f, chunk_a;

  __device__ __forceinline__ Stripe(const Params& p_, const int8_t* a_,
                                    const int8_t* b, const int* sub_,
                                    int* bh, int* bf, int* fl, int* rc,
                                    int s_)
      : p(p_), a(a_), sub(sub_), bound_h(bh), bound_f(bf), flags(fl),
        right(rc), s(s_) {
    lane = threadIdx.x & 31;
    row0 = (s * 32 + lane) * R;
    base = static_cast<int64_t>(s % p.slots) * p.mpad;
    above = static_cast<int64_t>((s + p.slots - 1) % p.slots) * p.mpad;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int code = b[row0 + r];
      bcode[r] = SUB ? code + 3 : code;
      h[r] = 0;
      e[r] = kNeg;
      bs[r] = 0;
      bj[r] = 0;
    }
    bot_h = 0;
    bot_f = kNeg;
    diag_top = 0;
    a_cur = -1;
    chunk_h = 0;
    chunk_f = kNeg;
    chunk_a = -1;
  }

  // Load the next 32 columns of the row above (waiting for the stripe above
  // to publish them) and of the query. Warp-uniform.
  __device__ __forceinline__ void load_chunk(int t) {
    if (s > 0) {
      if (lane == 0) {
        const int need = min(t + 32, p.m);
        while (ld_acquire(flags + s - 1) < need) __nanosleep(32);
      }
      __syncwarp();
      const int64_t idx = above + t + lane;
      chunk_h = __ldcg(bound_h + idx);
      if (AFFINE) chunk_f = __ldcg(bound_f + idx);
    }
    chunk_a = a[t + lane];
  }

  // Step t = t0 + u of a 32-step chunk; u (the lane lane 0 reads the row
  // above and the query from) is a compile-time constant.
  template <bool EDGE>
  __device__ __forceinline__ void step(int t, int src) {
    const int c = t - lane;
    int up_h = __shfl_up_sync(kFull, bot_h, 1);
    int up_f = AFFINE ? __shfl_up_sync(kFull, bot_f, 1) : 0;
    a_cur = __shfl_up_sync(kFull, a_cur, 1);
    const int top_h = __shfl_sync(kFull, chunk_h, src);
    const int top_f = AFFINE ? __shfl_sync(kFull, chunk_f, src) : 0;
    const int top_a = __shfl_sync(kFull, chunk_a, src);
    if (lane == 0) {
      up_h = top_h;
      up_f = top_f;
      a_cur = top_a;
    }

    const bool valid = !EDGE || static_cast<unsigned>(c) <
                                    static_cast<unsigned>(p.m);
    int d = diag_top;
    diag_top = up_h;
    int hu = up_h, fu = up_f;
    const int arow = SUB ? (a_cur + 3) * p.sub_dim : a_cur;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int sc = SUB ? sub[arow + bcode[r]]
                         : (a_cur == bcode[r] ? p.match : p.mismatch);
      int ev, fv;
      if (AFFINE) {
        ev = __viaddmax_s32(e[r], p.gap_extend, h[r] + p.gap_open);
        fv = __viaddmax_s32(fu, p.gap_extend, hu + p.gap_open);
      } else {
        ev = h[r] + p.gap_open;
        fv = hu + p.gap_open;
      }
      const int hn = __vimax3_s32_relu(d + sc, ev, fv);
      d = h[r];
      h[r] = hn;
      if (AFFINE) e[r] = ev;
      hu = hn;
      fu = fv;
      if (valid && hn > bs[r]) {
        bs[r] = hn;
        bj[r] = c + 1;
      }
    }
    bot_h = hu;
    bot_f = fu;

    if (EDGE && c < 0) {
      // not yet entered: hold the left boundary H(i, 0) = 0, E(i, 0) = -inf
#pragma unroll
      for (int r = 0; r < R; ++r) {
        h[r] = 0;
        e[r] = kNeg;
      }
      bot_h = 0;
      bot_f = kNeg;
      diag_top = 0;
    }
    if (valid) {
      if (lane == 31 && s + 1 < p.stripes) {
        bound_h[base + c] = bot_h;
        if (AFFINE) bound_f[base + c] = bot_f;
        if ((c & 31) == 31 || c == p.m - 1) st_release(flags + s, c + 1);
      }
      if (c == p.m - 1) {
#pragma unroll
        for (int r = 0; r < R; ++r) right[row0 + r] = h[r];
      }
    }
  }

  // 32 steps with the chunk's loads hoisted in front. Inside the matrix
  // (every lane on a real column for all 32 steps) no validity test is
  // needed; steps past the last column only touch lanes outside it.
  template <bool EDGE>
  __device__ __forceinline__ void chunk(int t0) {
    if (t0 < p.m) load_chunk(t0);
#pragma unroll
    for (int u = 0; u < 32; ++u) step<EDGE>(t0 + u, u);
  }

  __device__ __forceinline__ void run(int* __restrict__ bests) {
    const int steps = p.m + 31;
    for (int t0 = 0; t0 < steps; t0 += 32) {
      if (t0 >= 32 && t0 + 32 <= p.m)
        chunk<false>(t0);
      else
        chunk<true>(t0);
    }

    int tb = 0, ti = 0, tj = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r + 1;
      if (row <= p.n && bs[r] > tb) {
        tb = bs[r];
        ti = row;
        tj = bj[r];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ob = __shfl_down_sync(kFull, tb, off);
      const int oi = __shfl_down_sync(kFull, ti, off);
      const int oj = __shfl_down_sync(kFull, tj, off);
      if (lane + off < 32 && better(ob, oi, oj, tb, ti, tj)) {
        tb = ob;
        ti = oi;
        tj = oj;
      }
    }
    if (lane == 0) {
      bests[3 * s] = tb;
      bests[3 * s + 1] = ti;
      bests[3 * s + 2] = tj;
    }
  }
};

template <int R, bool AFFINE, bool SUB>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sw_fill_kernel(Params p, const int8_t* __restrict__ a,
               const int8_t* __restrict__ b, const int* __restrict__ sub,
               int* __restrict__ bests, int* __restrict__ right,
               int* __restrict__ bound_h, int* __restrict__ bound_f,
               int* __restrict__ flags) {
  extern __shared__ int sub_smem[];
  if (SUB) {
    for (int k = threadIdx.x; k < p.sub_dim * p.sub_dim; k += blockDim.x)
      sub_smem[k] = sub[k];
    __syncthreads();
  }
  const int warps = gridDim.x * kWarpsPerBlock;
  for (int s = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       s < p.stripes; s += warps) {
    Stripe<R, AFFINE, SUB> st(p, a, b, sub_smem, bound_h, bound_f, flags,
                              right, s);
    st.run(bests);
  }
}

template <int R, bool AFFINE, bool SUB>
cudaError_t launch(cudaStream_t stream, const Params& p, const int8_t* a,
                   const int8_t* b, const int* sub, int* bests, int* right,
                   int* bound_h, int* bound_f, int* flags) {
  auto kernel = sw_fill_kernel<R, AFFINE, SUB>;
  const int threads = kWarpsPerBlock * 32;
  const size_t smem = SUB ? sizeof(int) * p.sub_dim * p.sub_dim : 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // persistent grid: never more blocks than can be resident at once, since
  // a stripe spins on the flag of the stripe above it
  const int want = (p.stripes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int grid = want < sms * per_sm ? want : sms * per_sm;
  kernel<<<grid, threads, smem, stream>>>(p, a, b, sub, bests, right,
                                          bound_h, bound_f, flags);
  return cudaGetLastError();
}

template <int R>
cudaError_t dispatch(bool affine, bool use_sub, cudaStream_t stream,
                     const Params& p, const int8_t* a, const int8_t* b,
                     const int* sub, int* bests, int* right, int* bound_h,
                     int* bound_f, int* flags) {
  if (affine) {
    return use_sub ? launch<R, true, true>(stream, p, a, b, sub, bests, right,
                                           bound_h, bound_f, flags)
                   : launch<R, true, false>(stream, p, a, b, sub, bests,
                                            right, bound_h, bound_f, flags);
  }
  return use_sub ? launch<R, false, true>(stream, p, a, b, sub, bests, right,
                                          bound_h, bound_f, flags)
                 : launch<R, false, false>(stream, p, a, b, sub, bests, right,
                                           bound_h, bound_f, flags);
}

ffi::Error SwFillImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> a,
                      ffi::Buffer<ffi::S8> b, ffi::Buffer<ffi::S32> sub,
                      ffi::ResultBuffer<ffi::S32> bests,
                      ffi::ResultBuffer<ffi::S32> right,
                      ffi::ResultBuffer<ffi::S32> bound_h,
                      ffi::ResultBuffer<ffi::S32> bound_f,
                      ffi::ResultBuffer<ffi::S32> flags, int32_t m, int32_t n,
                      int32_t rows_per_lane, int32_t affine, int32_t match,
                      int32_t mismatch, int32_t gap_open, int32_t gap_extend,
                      int32_t sub_dim) {
  const int R = rows_per_lane;
  Params p;
  p.m = m;
  p.n = n;
  p.stripes = static_cast<int>(flags->element_count());
  p.mpad = (m + 31) / 32 * 32;
  p.slots = static_cast<int>(bound_h->element_count() / p.mpad);
  p.match = match;
  p.mismatch = mismatch;
  p.gap_open = gap_open;
  p.gap_extend = gap_extend;
  p.sub_dim = sub_dim;
  if (m < 1 || n < 1)
    return ffi::Error::InvalidArgument("sw_fill: empty operand");
  if (static_cast<int64_t>(p.stripes) * 32 * R < n ||
      a.element_count() < static_cast<size_t>(p.mpad) ||
      b.element_count() < static_cast<size_t>(p.stripes) * 32 * R ||
      bests->element_count() != static_cast<size_t>(3 * p.stripes) ||
      right->element_count() < static_cast<size_t>(p.stripes) * 32 * R ||
      p.slots < 1 || (p.stripes > 1 && p.slots < 2) ||
      (affine && bound_f->element_count() < bound_h->element_count()))
    return ffi::Error::InvalidArgument("sw_fill: buffer shapes do not match");
  if (sub_dim > 0 && sub.element_count() <
                         static_cast<size_t>(sub_dim) * sub_dim)
    return ffi::Error::InvalidArgument("sw_fill: substitution table too small");

  cudaError_t err = cudaMemsetAsync(flags->typed_data(), 0,
                                    sizeof(int) * p.stripes, stream);
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("sw_fill: ") +
                                cudaGetErrorString(err));
  const bool use_sub = sub_dim > 0;
  const int8_t* ad = a.typed_data();
  const int8_t* bd = b.typed_data();
  const int* sd = sub.typed_data();
  int* out[5] = {bests->typed_data(), right->typed_data(),
                 bound_h->typed_data(), bound_f->typed_data(),
                 flags->typed_data()};
  switch (R) {
    case 4:
      err = dispatch<4>(affine != 0, use_sub, stream, p, ad, bd, sd, out[0],
                        out[1], out[2], out[3], out[4]);
      break;
    case 8:
      err = dispatch<8>(affine != 0, use_sub, stream, p, ad, bd, sd, out[0],
                        out[1], out[2], out[3], out[4]);
      break;
    case 16:
      err = dispatch<16>(affine != 0, use_sub, stream, p, ad, bd, sd, out[0],
                         out[1], out[2], out[3], out[4]);
      break;
    default:
      return ffi::Error::InvalidArgument(
          "sw_fill: rows_per_lane must be 4, 8 or 16");
  }
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("sw_fill launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SwFill, SwFillImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()    // a
                                  .Arg<ffi::Buffer<ffi::S8>>()    // b
                                  .Arg<ffi::Buffer<ffi::S32>>()   // sub
                                  .Ret<ffi::Buffer<ffi::S32>>()   // bests
                                  .Ret<ffi::Buffer<ffi::S32>>()   // right
                                  .Ret<ffi::Buffer<ffi::S32>>()   // bound_h
                                  .Ret<ffi::Buffer<ffi::S32>>()   // bound_f
                                  .Ret<ffi::Buffer<ffi::S32>>()   // flags
                                  .Attr<int32_t>("m")
                                  .Attr<int32_t>("n")
                                  .Attr<int32_t>("rows_per_lane")
                                  .Attr<int32_t>("affine")
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("gap_open")
                                  .Attr<int32_t>("gap_extend")
                                  .Attr<int32_t>("sub_dim"));
