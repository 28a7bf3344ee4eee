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
// What bounds it on the H100: the j + 2 sums across blocks, then device
// memory. The least traffic reads each v_i once, w once and writes v_{j+1}
// once: at the matrix-free saddle's n = 17,396 and q = 46 in float32, 1.7 GB
// a 30-step cycle (0.50 ms at 3.35 TB/s), against 525 sums a cycle. A sum
// across the card (a grid barrier on a word of device memory, then every
// block reading every block's partials) took about 5,000 of a pass's 9,400
// cycles. The design keeps every sum inside a thread-block cluster:
//   - the columns are independent (each is its own Arnoldi process), so the
//     grid is one cluster for each group of columns: one cluster over all of
//     them where they are few, else as many clusters as the card holds at
//     once, each owning a contiguous range of columns. No block ever waits
//     on a block of another cluster: no grid barrier, no cooperative launch,
//     no partials in device memory;
//   - a cluster's blocks each own a contiguous slab of rows of the cluster's
//     columns; each thread owns fixed runs of V elements of the slab (16
//     bytes where the shape and addresses allow, else one element) through
//     the whole sweep, at a stride that is a multiple of the cluster's
//     columns, so that each of its elements keeps its column;
//   - where the block's shared memory holds w and three basis slabs (the
//     "on-chip" parameter set, picked by mgs_step_plan from n, q and the
//     element size), w is copied in with v_0 and stays in shared memory, and
//     each v_i is copied in with cp.async two passes before the pass that
//     reads it: every basis vector is read from device memory once. Otherwise w lives in v_{j+1}'s slot
//     of the basis and every pass reads it there (the streamed set, for the
//     wide blocks of the matrix-free rollouts);
//   - a pass fuses the update with v_{i-1} and the product with v_i, so a
//     step is j + 2 passes and j + 2 sums;
//   - each block sends its partial of each column into the shared memory of
//     every block of its cluster (st.async over distributed shared memory),
//     each store completing bytes of the receiver's mbarrier; a block waits
//     on its own mbarrier for its cluster's partials and sums them there.
//     The exchange has no cluster-wide barrier a pass: a block waits only
//     for the partials it needs (on one cluster at q = 4 and n = 17,396, a
//     hardware cluster barrier a pass and reads of the other blocks' shared
//     memory took 1.38 ms a 30-step cycle, this exchange 1.14 ms). One
//     cluster barrier a launch orders the mbarriers' set-up before the
//     first store;
//   - partials alternate between two buffers, each with its mbarrier, since
//     a block can send the next pass's partials before a slower one has
//     summed the last pass's; a block sends pass k + 2's only after it has
//     every block's pass k + 1 partial, sent after that block summed pass k;
//   - each column's sum is taken in a fixed order, so that every block gets
//     the same h[i, j] and results repeat bit for bit on one card: the
//     block's positions by warp shuffles and a warp a column, then the
//     cluster's blocks in rank order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMinThreads = 128;
constexpr int kElemsPerThread = 16;  // elements of its slab a thread a pass
constexpr int kMinElems = 1024;  // fewer elements a block only add partials
constexpr int kDepth = 2;  // basis vectors in flight ahead of their pass
// Blocks of a cluster: 16, beyond the portable 8, where the card admits it.
constexpr int kClusterBlocks = 16;
// One cluster over all columns where w and the slabs fit on chip and a
// basis vector has at most this many bytes (16 SMs stream it in a pass).
constexpr int64_t kOneClusterBytes = int64_t(3) << 17;

// The slab rows of a block (a multiple of V) and the rows of a chunk: the
// most whose positions V * threads threads' runs cover, at most the slab's,
// with rows * qc a multiple of V. The host plans with the same functions.
__host__ __device__ inline int64_t block_rows(int64_t n, int64_t nb, int V) {
  return ((n + nb - 1) / nb + V - 1) / V * V;
}
__host__ __device__ inline int64_t chunk_rows(int64_t qc, int64_t rows, int V,
                                              int threads) {
  int64_t rc = V * threads / qc;
  rc = rc < 1 ? 1 : (rc > rows ? rows : rc);
  while ((rc * qc) % V != 0) --rc;
  return rc;
}
// Elements of shared memory: the positions of a chunk (red), the column
// sums (tot), the partials a block receives (two buffers of a row of tot's
// size for each block of the cluster), and on chip w and kDepth + 1 basis
// slabs.
__host__ __device__ inline int64_t red_size(int64_t qc, int V, int threads) {
  return V * threads > qc ? V * threads : qc;
}
__host__ __device__ inline int64_t tot_size(int64_t qc, int V) {
  return (qc + V - 1) / V * V;
}
// Lanes of a warp whose runs are of different columns: qc / gcd(qc, V).
// Where it divides 32, lanes l and l + L hold the same columns in every warp
// and the block's sum starts with warp shuffles.
__host__ __device__ inline int lane_period(int64_t qc, int V) {
  int64_t a = qc, b = V;
  while (b) { const int64_t r = a % b; a = b; b = r; }
  return static_cast<int>(qc / a);
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

// The cluster: this block's rank in it, its blocks, its index.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_index() {
  unsigned r;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
// The hardware cluster barrier: every thread of the cluster arrives
// (releasing its writes) and waits (acquiring the others').
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address of *p in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(s), "r"(rank));
  return a;
}
// An mbarrier in shared memory that completes a phase when its one arrival
// has been made and the bytes it expects have landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;\n" :: "r"(s) : "memory");
}
// The arrival of the phase that ends when `bytes` more have landed.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  uint64_t state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
               : "=l"(state) : "r"(s), "r"(bytes) : "memory");
}
// Wait for the phase of parity `parity` to complete; acquires at cluster
// scope what the remote stores that completed it wrote.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(s), "r"(parity) : "memory");
  }
}
// v into the cluster's shared memory at `addr` (cluster_addr), completing
// sizeof(v) bytes of the mbarrier at `bar` (cluster_addr, same block).
__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async(unsigned addr, double v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
               :: "r"(addr), "l"(__double_as_longlong(v)), "r"(bar) : "memory");
}

// The sum of a warp's values v, the same in every lane: a fixed butterfly
// (a + b and b + a round alike).
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int s = 16; s >= 1; s /= 2) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// emit(c, sum over k < K of load(k, c)) for every c < q, in every lane of
// a warp: a warp for each of two columns at a time, each lane summing k =
// lane, lane + 32, ... in order, then the butterfly.
template <typename T, typename Load, typename Emit>
__device__ __forceinline__ void sum_columns(Load load, int K, int q, Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int c0 = warp; c0 < q; c0 += 2 * warps) {
    const int c1 = c0 + warps;
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
    emit(c0, s0);
    if (c1 < q) emit(c1, s1);
  }
}

// One Arnoldi step's orthogonalisation (file comment), launched as clusters,
// cluster i owning columns [i qc, min(q, (i + 1) qc)). vs (m + 1, n, q):
// reads v_0..v_j and writes v_{j+1}; w (n, q) is read only; h (m + 1, m,
// q): writes h[0..j+1, j]; safe_beta (q,). With V > 1, vs and w are 16-byte
// aligned (the launch checks), and either the cluster owns every column and
// n q is a multiple of V, or q and qc are.
template <typename T, bool OnChip, int V>
__global__ void __launch_bounds__(kMaxThreads, 1)
mgs_step_kernel(T* vs, const T* __restrict__ w, T* __restrict__ h,
                const T* __restrict__ safe_beta, int64_t n, int64_t q,
                int64_t qc, int64_t m, int64_t j, T factor) {
  using P = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, nt = blockDim.x, warps = nt >> 5;
  const int lane = t & 31, warp = t >> 5;
  const unsigned rank = cluster_rank(), cs = cluster_blocks();
  // The cluster's columns [c_lo, c_lo + qg) and the block's rows [r0, r1).
  const int64_t c_lo = cluster_index() * qc;
  const int qg = static_cast<int>(min(qc, q - c_lo));
  const int ji = static_cast<int>(j);
  const int64_t rows = block_rows(n, cs, V);
  const int64_t r0 = min(n, rank * rows), r1 = min(n, r0 + rows);
  const int64_t len = (r1 - r0) * qg;  // this block's elements
  const int64_t slab = rows * qc;
  const int rc = static_cast<int>(chunk_rows(qg, rows, V, nt));
  const int span = rc * qg;  // positions of a chunk
  const int qt = static_cast<int>(tot_size(qc, V));
  // Shared memory: two mbarriers, red, tot, the partials received (a row
  // of qt for each block of the cluster, two buffers), on chip w and the
  // slabs (compact: element e of the slab is row e / qg, column e % qg).
  uint64_t* const mbar = reinterpret_cast<uint64_t*>(smem);
  T* const red = reinterpret_cast<T*>(smem + 2 * sizeof(uint64_t));
  T* const tot = red + red_size(qc, V, nt);
  T* const recv = tot + qt;
  T* const wb = recv + 2 * cs * qt;
  const int64_t nq = n * q;
  T* const wv = vs + (j + 1) * nq;  // streamed: w between passes
  // This thread's runs: positions p = V t, V t + V nt, ... of every chunk;
  // the elements p + i span + v, v < V, are of column (p + v) % qg, at
  // g(p) + i rc q + v in a (n, q) block.
  const int p0 = V * t;
  const int stride = V * nt;
  const int64_t gstride = rc * q;
  auto gbase = [=](int p) { return (r0 + p / qg) * q + c_lo + p % qg; };
  auto column = [=](int c0, int v) {  // (c0 + v) % qg for c0 < qg
    int c = c0 + v;
    while (c >= qg) c -= qg;
    return c;
  };
  // Where a chunk is one position a thread and L divides 32, the block's
  // sum starts with shuffles within the lanes of a column: lanes l < L then
  // hold slots l V + v, of column (l V + v) % qg, dup times each column.
  const int L = lane_period(qg, V);
  const bool lanes = span <= stride && L <= 32 && (L & (L - 1)) == 0;
  const int dup = lanes ? L * V / qg : 0;
  // A pass's partials: qg from each block of the cluster.
  const unsigned bytes = cs * static_cast<unsigned>(qg) * sizeof(T);

  // On chip: w's slab into wb with v_0's, and v_i's into buffer i % (kDepth
  // + 1), one commit group a vector (empty past v_j), kDepth vectors ahead
  // of the pass that reads it.
  auto vbuf = [=](int i) { return wb + slab * (1 + i % (kDepth + 1)); };
  auto copy = [=](T* dst, const T* src) {
    for (int p = p0; p < span; p += stride) {
      int64_t g = gbase(p);
      for (int64_t e = p; e < len; e += span, g += gstride)
        cp_async<T, V>(dst + e, src + g);
    }
  };
  auto fetch = [=](int i) {
    if (i <= ji) copy(vbuf(i), vs + i * nq);
    cp_async_commit();
  };
  if constexpr (OnChip) {
    copy(wb, w);
    for (int i = 0; i < kDepth; ++i) fetch(i);
  }
  if (t == 0) {
    mbar_init(mbar);
    mbar_init(mbar + 1);
    mbar_expect(mbar, bytes);  // passes 0 and 1 (j + 2 >= 2 passes)
    mbar_expect(mbar + 1, bytes);
  }

  // Pass k: w -= h[k-1, j] v_{k-1} (k >= 1), then the partial sums of
  // <v_k, w> (k <= j) or of <w, w> (k = j + 1).
  for (int k = 0; k <= ji + 1; ++k) {
    const bool dot = k <= ji;
    const int bi = k & 1;
    T* const rk = recv + bi * static_cast<int64_t>(cs) * qt;
    if constexpr (OnChip) cp_async_wait_but_newest();  // this thread's v_k
    const bool from_w = !OnChip && k <= 1;  // streamed: w until pass 1 stores it
    const T* vprev = OnChip ? vbuf(k + kDepth) : vs + (k >= 1 ? k - 1 : 0) * nq;
    const T* vcur = OnChip ? vbuf(k) : vs + k * nq;
    T mine[V];  // with `lanes`, this thread's one position's sums
#pragma unroll
    for (int v = 0; v < V; ++v) mine[v] = T(0);
    for (int p = p0; p < span; p += stride) {
      const int c0 = p % qg;
      T hprev[V], acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        hprev[v] = k >= 1 ? tot[column(c0, v)] : T(0);
        acc[v] = T(0);
      }
      int64_t g = gbase(p);
      for (int64_t e = p; e < len; e += span, g += gstride) {
        // Shared buffers by e, device memory by g.
        P x = ld<T, V>(OnChip ? wb + e : (from_w ? w + g : wv + g));
        if (k >= 1) {
          const P a = ld<T, V>(OnChip ? vprev + e : vprev + g);
#pragma unroll
          for (int v = 0; v < V; ++v) x.x[v] = fma_t(-hprev[v], a.x[v], x.x[v]);
        }
        const P y = dot ? ld<T, V>(OnChip ? vcur + e : vcur + g) : x;
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fma_t(x.x[v], y.x[v], acc[v]);
        if constexpr (OnChip) {
          st<T, V>(wb + e, x);
        } else {
          if (k >= 1) st<T, V>(wv + g, x);
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (lanes) {
          mine[v] = acc[v];
        } else {
          red[p + v] = acc[v];
        }
      }
    }
    // The block's partial of column c, in every lane of a warp: lane d
    // stores it into block d's buffer, row `rank`.
    auto send = [=](int c, T s) {
      if (lane < static_cast<int>(cs))
        st_async(cluster_addr(rk + rank * qt + c, lane), s,
                 cluster_addr(mbar + bi, lane));
    };
    if (lanes) {
      for (int s = L; s < 32; s *= 2) {
#pragma unroll
        for (int v = 0; v < V; ++v) mine[v] += __shfl_xor_sync(0xffffffffu, mine[v], s);
      }
      if (lane < L) {
#pragma unroll
        for (int v = 0; v < V; ++v) red[(warp * L + lane) * V + v] = mine[v];
      }
      __syncthreads();
      if (k == 0) cluster_sync();  // every mbarrier is set up before a store
      // Column c's values: slot c + d qg of warp k / dup, d = k % dup.
      sum_columns<T>([=](int k2, int c) {
        return red[(k2 / dup) * L * V + (k2 % dup) * qg + c];
      }, warps * dup, qg, send);
    } else {
      __syncthreads();
      if (k == 0) cluster_sync();
      // The block's rows within the chunk.
      sum_columns<T>([=](int r, int c) { return red[r * qg + c]; }, rc, qg, send);
    }
    // v_{k+kDepth} into the buffer v_{k-1} left, issued before the wait.
    if constexpr (OnChip) fetch(k + kDepth);
    mbar_wait(mbar + bi, (k >> 1) & 1);
    if (t == 0 && k + 2 <= ji + 1) mbar_expect(mbar + bi, bytes);
    // The cluster's partials in rank order.
    sum_columns<T>([=](int r, int c) { return rk[r * qt + c]; },
                   static_cast<int>(cs), qg, [=](int c, T s) {
                     if (lane == 0) tot[c] = s;
                   });
    __syncthreads();
    if (rank == 0 && dot) {
      for (int c = t; c < qg; c += nt) h[(k * m + j) * q + c_lo + c] = tot[c];
    }
  }

  // tot holds ||w||^2: the breakdown test, h[j+1, j] and v_{j+1}.
  if (rank == 0) {
    for (int c = t; c < qg; c += nt) {
      const T hn = sqrt(tot[c]);
      h[((j + 1) * m + j) * q + c_lo + c] =
          hn < factor * safe_beta[c_lo + c] ? T(0) : hn;
    }
  }
  for (int p = p0; p < span; p += stride) {
    const int c0 = p % qg;
    T div[V];  // max(hnorm, 1e-30), keeping a NaN
    bool zero[V];  // breakdown
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = column(c0, v);
      const T hn = sqrt(tot[c]);
      zero[v] = hn < factor * safe_beta[c_lo + c];
      div[v] = hn < T(1e-30) ? T(1e-30) : hn;
    }
    int64_t g = gbase(p);
    for (int64_t e = p; e < len; e += span, g += gstride) {
      P x = ld<T, V>(OnChip ? wb + e : wv + g);
#pragma unroll
      for (int v = 0; v < V; ++v) x.x[v] = zero[v] ? T(0) : x.x[v] / div[v];
      st<T, V>(wv + g, x);
    }
  }
}

template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <typename T>
size_t shared_bytes(int64_t qc, int64_t slab, bool onchip, int V, int threads,
                    int cluster) {
  return 2 * sizeof(uint64_t) +
         (red_size(qc, V, threads) + (1 + 2 * cluster) * tot_size(qc, V) +
          (onchip ? (kDepth + 2) * slab : 0)) * sizeof(T);
}

template <typename T, bool OnChip>
const void* kernel(int V) {
  return V == 1 ? reinterpret_cast<const void*>(mgs_step_kernel<T, OnChip, 1>)
                : reinterpret_cast<const void*>(mgs_step_kernel<T, OnChip, kVec<T>>);
}

// Clusters of `blocks` blocks of `threads` that can be resident at once (0
// where none).
int max_clusters(const void* fn, int blocks, int threads, size_t smem, int* out) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  *out = 0;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, fn, &cfg));
}

// Threads of a block whose slab holds `elems` elements: a power of two
// near elems / kElemsPerThread in [kMinThreads, kMaxThreads], at least qc
// where runs of V > 1 elements need every column of a chunk on its own
// thread. A block's fixed work a pass (its sums, the exchange, the
// prefetch's issue) costs every warp issue slots, so a small slab takes few
// threads.
int block_threads(int64_t elems, int64_t qc, int V) {
  const int64_t want = elems / kElemsPerThread;
  int64_t t = kMinThreads;
  while (t < kMaxThreads && (3 * t) / 2 < want) t *= 2;
  if (V > 1 && qc % V != 0) {
    while (t < qc) t *= 2;
  }
  return static_cast<int>(t > kMaxThreads ? kMaxThreads : t);
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
  // Both element widths (a launch on addresses off 16 bytes takes V = 1,
  // whose shared memory is no larger) and both parameter sets: the limit
  // is the card's most, since plans of other shapes share the kernels.
  for (int v : {1, kVec<T>}) {
    for (const void* fn : {kernel<T, true>(v), kernel<T, false>(v)}) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  // Clusters of cs blocks owning qc columns with runs of V: threads, shared
  // memory, whether w stays on chip, and how many are resident at once for
  // both element widths.
  struct Layout {
    int threads = 0, resident = 0;
    bool onchip = false;
    size_t smem = 0;
  };
  auto layout = [&](int cs, int64_t qc, int V, Layout* l) {
    const int64_t rows = block_rows(n, cs, V);
    l->threads = block_threads(rows * qc, qc, V);
    l->onchip = shared_bytes<T>(qc, rows * qc, true, V, l->threads, cs) <=
                static_cast<size_t>(optin);
    l->smem = shared_bytes<T>(qc, rows * qc, l->onchip, V, l->threads, cs);
    l->resident = 1 << 30;
    if (l->smem > static_cast<size_t>(optin)) {
      l->resident = 0;
      return cudaSuccess;
    }
    for (int v : {1, V}) {
      int c = 0;
      const cudaError_t e = static_cast<cudaError_t>(max_clusters(
          l->onchip ? kernel<T, true>(v) : kernel<T, false>(v), cs, l->threads,
          l->smem, &c));
      if (e != cudaSuccess) return e;
      l->resident = c < l->resident ? c : l->resident;
    }
    return cudaSuccess;
  };
  Layout l;
  int cs = 0, V = 1;
  int64_t qc = q;
  // One cluster over every column (of up to kClusterBlocks, one block for
  // each kMinElems elements) where that takes all the elements, or w fits
  // on chip and a basis vector is small. Its runs may cross rows.
  const int64_t want = n * q / kMinElems < 1 ? 1 : n * q / kMinElems;
  const int V1 = (n * q) % kVec<T> == 0 && (q % kVec<T> == 0 || q <= kMaxThreads)
                     ? kVec<T> : 1;
  int64_t top = 1;
  while (top < want && top < kClusterBlocks) top *= 2;
  for (int64_t c1 = top; c1 >= 1 && cs == 0; c1 /= 2) {
    err = layout(static_cast<int>(c1), q, V1, &l);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (want > c1 && !(l.onchip && n * q * static_cast<int64_t>(sizeof(T)) <= kOneClusterBytes))
      break;
    if (l.resident >= 1) cs = static_cast<int>(c1), V = V1;
  }
  if (cs == 0) {
    // Clusters of kClusterBlocks (8 where the card admits no 16), each
    // owning a range of columns: a multiple of V, which rows only keep
    // where q is one. (Runs of 16 bytes in shared memory that cross the
    // slab's rows, moved one element at a time from device memory, were
    // slower at q = 46 than one-element runs.)
    V = q % kVec<T> == 0 ? kVec<T> : 1;
    for (cs = kClusterBlocks; cs >= 8; cs /= 2) {
      err = layout(cs, V, V, &l);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (l.resident >= 1) break;
    }
    if (l.resident < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    // The clusters the card holds at once at one block an SM.
    int slots = 0;
    err = static_cast<cudaError_t>(
        max_clusters(kernel<T, false>(V), cs, kMaxThreads, l.smem, &slots));
    if (err != cudaSuccess) return static_cast<int>(err);
    slots = slots < sms / cs ? slots : sms / cs;
    if (slots < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    // qc for `groups` clusters; the clusters that then own every column.
    auto split = [&](int64_t groups) {
      qc = ((q + groups - 1) / groups + V - 1) / V * V;
      return (q + qc - 1) / qc;
    };
    // As many clusters as the card holds at once; where w then does not
    // fit on chip, the fewest more that keep it there, up to two waves of
    // clusters; else streamed.
    const int64_t most = q / V, first = most < slots ? most : slots;
    for (int64_t g = first; g <= most && g <= 2 * slots; ++g) {
      if (split(g) > 2 * slots) break;
      err = layout(cs, qc, V, &l);
      if (err != cudaSuccess || l.onchip) break;
    }
    if (err == cudaSuccess && !l.onchip) {
      split(first);
      err = layout(cs, qc, V, &l);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (l.resident < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  }
  const int64_t clusters = (q + qc - 1) / qc;
  out[0] = static_cast<int32_t>(clusters * cs);
  out[1] = static_cast<int32_t>(l.smem);
  out[2] = l.onchip ? 1 : 0;
  out[3] = V;
  out[4] = cs;
  out[5] = l.threads;
  out[6] = static_cast<int32_t>(qc);
  return 0;
}

template <typename T>
int launch(T* vs, const T* w, T* h, const T* safe_beta, int64_t n, int64_t q,
           int64_t m, int64_t j, double factor, int64_t grid, int64_t cluster,
           int64_t threads, int64_t smem, int64_t onchip, int64_t vec,
           int64_t qc, void* stream) {
  T f = static_cast<T>(factor);
  const bool aligned = reinterpret_cast<uintptr_t>(vs) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int V = vec > 1 && aligned ? kVec<T> : 1;
  const void* fn = onchip ? kernel<T, true>(V) : kernel<T, false>(V);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned int>(grid));
  cfg.blockDim = dim3(static_cast<unsigned int>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&vs, &w, &h, &safe_beta, &n, &q, &qc, &m, &j, &f};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The launch parameters for (n, q) blocks on the current device: out[0] the
// grid, out[1] the bytes of dynamic shared memory, out[2] 1 where w stays
// on chip, out[3] the elements a run (1, or 16 bytes' worth), out[4] the
// blocks of a cluster (the grid is one cluster where it equals out[0]),
// out[5] the threads of a block, out[6] the columns a cluster owns. Raises
// the kernels' shared-memory limit and allows clusters beyond the portable
// 8. Returns a cudaError_t as an int.
int mgs_step_plan_f32(int64_t n, int64_t q, int32_t* out) {
  return plan<float>(n, q, out);
}
int mgs_step_plan_f64(int64_t n, int64_t q, int32_t* out) {
  return plan<double>(n, q, out);
}

// One launch on `stream` with a plan of mgs_step_plan_*; returns its
// cudaError_t as an int.
int mgs_step_f32(float* vs, const float* w, float* h, const float* safe_beta,
                 int64_t n, int64_t q, int64_t m, int64_t j, double factor,
                 int64_t grid, int64_t cluster, int64_t threads, int64_t smem,
                 int64_t onchip, int64_t vec, int64_t qc, void* stream) {
  return launch<float>(vs, w, h, safe_beta, n, q, m, j, factor, grid, cluster,
                       threads, smem, onchip, vec, qc, stream);
}
int mgs_step_f64(double* vs, const double* w, double* h,
                 const double* safe_beta, int64_t n, int64_t q, int64_t m,
                 int64_t j, double factor, int64_t grid, int64_t cluster,
                 int64_t threads, int64_t smem, int64_t onchip, int64_t vec,
                 int64_t qc, void* stream) {
  return launch<double>(vs, w, h, safe_beta, n, q, m, j, factor, grid, cluster,
                        threads, smem, onchip, vec, qc, stream);
}

const char* mgs_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
