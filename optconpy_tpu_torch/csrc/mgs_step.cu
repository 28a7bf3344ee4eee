// The orthogonalisation of one Arnoldi step of GMRES, for Hopper (sm_90a),
// in float32 and float64: modified Gram-Schmidt of w against the basis
// v_0..v_j, its norm, the breakdown test, the new basis vector and the column
// of the Hessenberg matrix, all in one launch.
//
// Replaces no TPU kernel: the reference runs this loop as a lax.fori_loop in
// optconpy_tpu/solvers/krylov.py (gmres), which XLA fuses. The port ran it as
// three launches a projection (a product, a column sum and an addcmul) and
// about a dozen more a step, 1,755 launches of 2-5 us each a 30-step cycle.
//
// Per column c of the (n, q) blocks, in this order (what solvers/krylov.py's
// loop computes; ops/arnoldi_kernel.py::mgs_step_plain is that loop):
//   for i = 0..j:  h[i, j] = <v_i, w>;  w -= h[i, j] v_i
//   hnorm = ||w||;  breakdown = hnorm < factor * safe_beta   (factor 64 eps)
//   h[j+1, j] = breakdown ? 0 : hnorm
//   v_{j+1}   = breakdown ? 0 : w / max(hnorm, 1e-30)
//
// What bounds it on the H100: the j + 2 grid-wide sums, then device memory.
// The least traffic reads each v_i once, w once and writes v_{j+1} once: at
// the matrix-free saddle's n = 17,396 and q = 46 in float32, 1.7 GB a 30-step
// cycle (0.50 ms at 3.35 TB/s), against 525 sums, each a grid barrier of
// 1.1 us. The design:
//   - one persistent cooperative grid, at most one block an SM, each block
//     owning a contiguous slab of rows of all q columns (row-major, so the
//     slab is one run of memory);
//   - each thread owns fixed runs of V elements of the slab (16 bytes where
//     the shape and addresses allow, else one element) through the whole
//     sweep, at a stride that is a multiple of q, so that each of its
//     elements keeps its column;
//   - where the grid's shared memory holds w and three basis slabs (the
//     "on-chip" parameter set, picked by mgs_step_plan from n, q and the
//     element size), w stays in shared memory and each v_i is copied in with
//     cp.async two passes before the pass that reads it: every basis vector
//     is read from device memory once. Otherwise w lives in v_{j+1}'s slot
//     of the basis and every pass reads it there (the streamed set, for the
//     wide blocks of the matrix-free rollouts);
//   - a pass fuses the update with v_{i-1} and the product with v_i, so a
//     step is j + 2 passes and j + 2 grid barriers;
//   - each column's sum is taken in a fixed order: the block's rows by a
//     warp into one partial a block, then, after the barrier, every block
//     sums all blocks' partials by a warp a column, each lane in block
//     order, then a fixed butterfly of shuffles. Every block gets the same
//     h[i, j], and results repeat bit for bit on one card. Partials
//     alternate between two buffers, since a block can reach the next pass's
//     write before a slower one has read the last pass's partials;
//   - the grid barrier is one word of device memory that the caller keeps
//     for its stream, split into an arrival and a wait, so that the next
//     prefetch is issued between them: cooperative_groups' algorithm with a
//     release atomic and acquire loads in place of its fences (up to 15%
//     less time a cycle than its grid barrier; its header took 3.5 s of
//     this file's 8.8 s of nvcc).

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 1024;  // one block an SM
constexpr int kWarps = kThreads / 32;
constexpr int kMinElems = 1024;  // fewer elements a block only add partials
constexpr int kDepth = 2;  // basis vectors in flight ahead of their pass

// The slab rows of a block (a multiple of V) and the rows of a chunk: the
// most whose positions V * kThreads threads' runs cover, at most the slab's,
// with rows * q a multiple of V. The host plans with the same functions.
__host__ __device__ inline int64_t block_rows(int64_t n, int64_t nb, int V) {
  return ((n + nb - 1) / nb + V - 1) / V * V;
}
__host__ __device__ inline int64_t chunk_rows(int64_t q, int64_t rows, int V) {
  int64_t rc = V * kThreads / q;
  rc = rc < 1 ? 1 : (rc > rows ? rows : rc);
  while ((rc * q) % V != 0) --rc;
  return rc;
}
// Elements of shared memory: the positions of a chunk (red), the column
// sums (tot), and on chip w and kDepth + 1 basis slabs.
__host__ __device__ inline int64_t red_size(int64_t q, int V) {
  return V * kThreads > q ? V * kThreads : q;
}
__host__ __device__ inline int64_t tot_size(int64_t q, int V) {
  return (q + V - 1) / V * V;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T x[V];
};
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> ld(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}
template <typename T, int V>
__device__ __forceinline__ void st(T* p, const Pack<T, V>& v) {
  *reinterpret_cast<Pack<T, V>*>(p) = v;
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// Asynchronous copy of V elements (4, 8 or 16 bytes) to shared memory.
template <typename T, int V>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) * V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
  } else if constexpr (sizeof(T) * V == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most the newest group of this thread's copies is in flight.
__device__ __forceinline__ void cp_async_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The grid barrier on the word *bar, as cooperative_groups builds it: block
// 0 adds 0x80000000 - (gridDim.x - 1) and every other block 1, so the last
// arrival flips the top bit and leaves the low bits zero, as they were
// before the launch. A block's wait ends when the top bit differs from the
// one its arrival read. The block's writes before the arrival (ordered by
// __syncthreads, then released at GPU scope) are seen by every thread after
// the wait (an acquire load, then __syncthreads).
__device__ __forceinline__ unsigned grid_arrive(unsigned* bar) {
  __syncthreads();
  unsigned old = 0;
  if (threadIdx.x == 0) {
    const unsigned inc = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    asm volatile("atom.add.release.gpu.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(bar), "r"(inc) : "memory");
  }
  return old;
}
__device__ __forceinline__ void grid_wait(const unsigned* bar, unsigned old) {
  if (threadIdx.x == 0) {
    unsigned now;
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(now) : "l"(bar) : "memory");
    } while (((old ^ now) & 0x80000000u) == 0);
  }
  __syncthreads();
}

// The sum of a warp's values v, the same in every lane: a fixed butterfly
// (a + b and b + a round alike).
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int s = 16; s >= 1; s /= 2) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// out[c * stride] = sum over k < K of load(k, c), for every c < q: a warp
// for each of two columns at a time, each lane summing k = lane, lane + 32,
// ... in order, then the butterfly. Lane 0 stores.
template <typename T, typename Load>
__device__ __forceinline__ void sum_columns(Load load, int K, int q, T* out,
                                            int stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c0 = warp; c0 < q; c0 += 2 * kWarps) {
    const int c1 = c0 + kWarps;
    T s0 = T(0), s1 = T(0);
    if (c1 < q) {
#pragma unroll 4
      for (int k = lane; k < K; k += 32) {
        s0 += load(k, c0);
        s1 += load(k, c1);
      }
    } else {
#pragma unroll 4
      for (int k = lane; k < K; k += 32) s0 += load(k, c0);
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    if (lane == 0) {
      out[static_cast<int64_t>(c0) * stride] = s0;
      if (c1 < q) out[static_cast<int64_t>(c1) * stride] = s1;
    }
  }
}

// One Arnoldi step's orthogonalisation (file comment). vs (m + 1, n, q):
// reads v_0..v_j and writes v_{j+1}; w (n, q) is read only; h (m + 1, m, q):
// writes h[0..j+1, j]; safe_beta (q,); part (2, q, gridDim.x) scratch: each
// block's partial of column c at [c, block]; bar: the barrier's word. With
// V > 1, vs and w are 16-byte aligned and n q is a multiple of V (the launch
// checks).
template <typename T, bool OnChip, int V>
__global__ void __launch_bounds__(kThreads, 1)
mgs_step_kernel(T* vs, const T* __restrict__ w, T* __restrict__ h,
                const T* __restrict__ safe_beta, T* __restrict__ part,
                unsigned* bar, int64_t n, int64_t q, int64_t m, int64_t j,
                T factor) {
  using P = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = gridDim.x, b = blockIdx.x, t = threadIdx.x;
  const int qi = static_cast<int>(q), ji = static_cast<int>(j);
  const int64_t rows = block_rows(n, nb, V);
  const int64_t r0 = min(n, b * rows), r1 = min(n, r0 + rows);
  const int64_t len = (r1 - r0) * q;  // this block's elements
  const int64_t slab = rows * q;
  const int rc = static_cast<int>(chunk_rows(q, rows, V));
  const int span = rc * qi;  // positions of a chunk
  T* const red = reinterpret_cast<T*>(smem);
  T* const tot = red + red_size(q, V);
  T* const wb = tot + tot_size(q, V);
  const int64_t nq = n * q;
  const int64_t at0 = r0 * q;  // the slab's first element in a (n, q) block
  T* const wv_g = vs + (j + 1) * nq + at0;  // streamed: w between passes
  const T* const w_g = w + at0;
  // This thread's runs: positions p = V t, V t + V kThreads, ... of every
  // chunk; the elements p + i span + v, v < V, are of column (p + v) % q.
  const int p0 = V * t;
  constexpr int kStride = V * kThreads;
  auto column = [=](int c0, int v) {  // (c0 + v) % q for c0 < q
    int c = c0 + v;
    while (c >= qi) c -= qi;
    return c;
  };

  // On chip: v_i's slab into buffer i % (kDepth + 1), one commit group a
  // vector (empty past v_j), kDepth vectors ahead of the pass that reads it.
  auto vbuf = [=](int i) { return wb + slab * (1 + i % (kDepth + 1)); };
  auto fetch = [=](int i) {
    if (i <= ji) {
      T* dst = vbuf(i);
      const T* src = vs + i * nq + at0;
      for (int p = p0; p < span; p += kStride)
        for (int64_t e = p; e < len; e += span)
          cp_async<T, V>(dst + e, src + e);
    }
    cp_async_commit();
  };
  if constexpr (OnChip) {
    for (int i = 0; i < kDepth; ++i) fetch(i);
  }

  // Pass k: w -= h[k-1, j] v_{k-1} (k >= 1), then the partial sums of
  // <v_k, w> (k <= j) or of <w, w> (k = j + 1).
  for (int k = 0; k <= ji + 1; ++k) {
    const bool dot = k <= ji;
    T* const pk = part + (k & 1) * static_cast<int64_t>(nb) * q;
    if constexpr (OnChip) cp_async_wait_but_newest();  // this thread's v_k
    const T* vprev = OnChip ? vbuf(k + kDepth) : vs + (k >= 1 ? k - 1 : 0) * nq + at0;
    const T* vcur = OnChip ? vbuf(k) : vs + k * nq + at0;
    const T* wsrc = (k == 0 || (!OnChip && k == 1)) ? w_g : (OnChip ? wb : wv_g);
    for (int p = p0; p < span; p += kStride) {
      const int c0 = p % qi;
      T hprev[V], acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        hprev[v] = k >= 1 ? tot[column(c0, v)] : T(0);
        acc[v] = T(0);
      }
      for (int64_t e = p; e < len; e += span) {
        P x = ld<T, V>(wsrc + e);
        if (k >= 1) {
          const P a = ld<T, V>(vprev + e);
#pragma unroll
          for (int v = 0; v < V; ++v) x.x[v] = fma_t(-hprev[v], a.x[v], x.x[v]);
        }
        const P y = dot ? ld<T, V>(vcur + e) : x;
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fma_t(x.x[v], y.x[v], acc[v]);
        if constexpr (OnChip) {
          st<T, V>(wb + e, x);
        } else {
          if (k >= 1) st<T, V>(wv_g + e, x);
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) red[p + v] = acc[v];
    }
    __syncthreads();
    // The block's partial of each column: its rows within the chunk.
    sum_columns<T>([=](int r, int c) { return red[r * qi + c]; }, rc, qi,
                   pk + b, nb);
    const unsigned token = grid_arrive(bar);
    // v_{k+kDepth} into the buffer v_{k-1} left, issued after the arrival
    // so that the barrier's fence does not wait on it.
    if constexpr (OnChip) fetch(k + kDepth);
    grid_wait(bar, token);
    // Every block sums the blocks' partials in block order. They were
    // written by other SMs: read around L1.
    sum_columns<T>([=](int r, int c) { return __ldcg(pk + c * nb + r); }, nb,
                   qi, tot, 1);
    __syncthreads();
    if (b == 0 && dot) {
      for (int c = t; c < qi; c += kThreads) h[(k * m + j) * q + c] = tot[c];
    }
  }

  // tot holds ||w||^2: the breakdown test, h[j+1, j] and v_{j+1}.
  if (b == 0) {
    for (int c = t; c < qi; c += kThreads) {
      const T hn = sqrt(tot[c]);
      h[((j + 1) * m + j) * q + c] = hn < factor * safe_beta[c] ? T(0) : hn;
    }
  }
  for (int p = p0; p < span; p += kStride) {
    const int c0 = p % qi;
    T div[V];  // max(hnorm, 1e-30), keeping a NaN
    bool zero[V];  // breakdown
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = column(c0, v);
      const T hn = sqrt(tot[c]);
      zero[v] = hn < factor * safe_beta[c];
      div[v] = hn < T(1e-30) ? T(1e-30) : hn;
    }
    for (int64_t e = p; e < len; e += span) {
      P x = ld<T, V>(OnChip ? wb + e : wv_g + e);
#pragma unroll
      for (int v = 0; v < V; ++v) x.x[v] = zero[v] ? T(0) : x.x[v] / div[v];
      st<T, V>(wv_g + e, x);
    }
  }
}

template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <typename T>
size_t shared_bytes(int64_t q, int64_t slab, bool onchip, int V) {
  return (red_size(q, V) + tot_size(q, V) + (onchip ? (kDepth + 2) * slab : 0)) *
         sizeof(T);
}

template <typename T, bool OnChip>
const void* kernel(int V) {
  return V == 1 ? reinterpret_cast<const void*>(mgs_step_kernel<T, OnChip, 1>)
                : reinterpret_cast<const void*>(mgs_step_kernel<T, OnChip, kVec<T>>);
}

template <typename T>
int plan(int64_t n, int64_t q, int32_t* out) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || q < 1 || q > (int64_t(1) << 24) || n * q >= (int64_t(1) << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t grid = n * q / kMinElems;
  grid = grid < 1 ? 1 : (grid > sms ? sms : grid);
  // Runs of 16 bytes where every block's slab and every basis vector start
  // on them and each run stays in its columns' chunk.
  const int V = (n * q) % kVec<T> == 0 && (q % kVec<T> == 0 || q <= kThreads)
                    ? kVec<T> : 1;
  const int64_t slab = block_rows(n, grid, V) * q;
  const bool onchip = shared_bytes<T>(q, slab, true, V) <= static_cast<size_t>(optin);
  const size_t smem = shared_bytes<T>(q, slab, onchip, V);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  // Both element widths: a launch on addresses off 16 bytes takes V = 1,
  // whose shared memory is no larger.
  for (int v : {1, V}) {
    const void* fn = onchip ? kernel<T, true>(v) : kernel<T, false>(v);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  out[0] = static_cast<int32_t>(grid);
  out[1] = static_cast<int32_t>(smem);
  out[2] = onchip ? 1 : 0;
  out[3] = V;
  return 0;
}

template <typename T>
int launch(T* vs, const T* w, T* h, const T* safe_beta, T* part,
           unsigned* bar, int64_t n, int64_t q, int64_t m, int64_t j,
           double factor, int64_t grid, int64_t smem, int64_t onchip,
           int64_t vec, void* stream) {
  T f = static_cast<T>(factor);
  void* args[] = {&vs, &w, &h, &safe_beta, &part, &bar, &n, &q, &m, &j, &f};
  const bool aligned = reinterpret_cast<uintptr_t>(vs) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int V = vec > 1 && aligned ? kVec<T> : 1;
  const void* fn = onchip ? kernel<T, true>(V) : kernel<T, false>(V);
  const cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(static_cast<unsigned int>(grid)), dim3(kThreads), args,
      static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The launch parameters for (n, q) blocks on the current device: out[0] the
// grid (at most one block an SM), out[1] the bytes of dynamic shared memory,
// out[2] 1 where w stays on chip, out[3] the elements a run (1, or 16 bytes'
// worth). Raises the kernels' shared-memory limit. Returns a cudaError_t as
// an int.
int mgs_step_plan_f32(int64_t n, int64_t q, int32_t* out) {
  return plan<float>(n, q, out);
}
int mgs_step_plan_f64(int64_t n, int64_t q, int32_t* out) {
  return plan<double>(n, q, out);
}

// One cooperative launch on `stream` with a plan of mgs_step_plan_*; returns
// its cudaError_t as an int. part holds 2 * grid * q values; bar is a word
// whose low 31 bits are zero, which no launch on another stream uses.
int mgs_step_f32(float* vs, const float* w, float* h, const float* safe_beta,
                 float* part, unsigned* bar, int64_t n, int64_t q, int64_t m,
                 int64_t j, double factor, int64_t grid, int64_t smem,
                 int64_t onchip, int64_t vec, void* stream) {
  return launch<float>(vs, w, h, safe_beta, part, bar, n, q, m, j, factor,
                       grid, smem, onchip, vec, stream);
}
int mgs_step_f64(double* vs, const double* w, double* h,
                 const double* safe_beta, double* part, unsigned* bar,
                 int64_t n, int64_t q, int64_t m, int64_t j, double factor,
                 int64_t grid, int64_t smem, int64_t onchip, int64_t vec,
                 void* stream) {
  return launch<double>(vs, w, h, safe_beta, part, bar, n, q, m, j, factor,
                        grid, smem, onchip, vec, stream);
}

const char* mgs_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
