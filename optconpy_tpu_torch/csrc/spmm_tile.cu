// Sparse times dense, Y = A X, for Hopper (sm_90a), in float32 and float64.
//
// Replaces the TPU kernel optconpy_tpu/ops/pallas_spmm.py::windowed_dense_spmm
// (Y = A X for an RCM-ordered FEM operator) and the row-per-block ELL kernel
// that first ported it. The TPU kernel ran one dense (128, w) matrix-unit
// product per row tile over its column window; here the CUDA cores compute
// from the nonzeros.
//
// What bounds it on the H100: at the Newton-Schulz width (B = 17,396) the
// bytes: X read once and Y written once, 2.13 GB for the refinement-2
// cylinder's A~^T in float32 (0.64 ms at 3.35 TB/s), against 2 flop per
// nonzero and column (0.18 ms). The earlier kernel read each X value into a
// register for a single FMA and loaded X once per nonzero and column (23.7 GB
// of requests for A~^T). The design cuts the loads and keeps X in the caches:
//   - a warp holds the outputs of kGroup consecutive rows (a group) for CPT
//     adjacent columns per lane, and walks the sorted union of the group's
//     columns (the host pads missing (row, column) pairs with zeros). One
//     16-byte load of X (CPT values) feeds kGroup * CPT FMAs, and the group's
//     entries (kGroup values and the column) are read from shared memory,
//     where the block stages them once: 0.43 loads of X per nonzero for A~^T
//     instead of 1;
//   - X is read through L1 (the read-only path), where the groups of a block
//     and of its neighbours on the SM share most of their columns (P2 stencils
//     in RCM order). Staging X in shared memory instead was slower on the H100:
//     the union of a tile's columns is 2-5x its rows, and a block waits on
//     each staged tile;
//   - grid (row tiles, column tiles), row tiles fastest: the blocks in flight
//     work on the same few column tiles, so X's slab for those columns stays
//     in L2 and X comes from device memory about once. The host picks CPT so
//     that this slab fits in half of L2 (the wide J, whose 2,080 rows read all
//     15,316 rows of X, takes fewer columns per lane);
//   - each output is the sum over its group's entries in their fixed sorted
//     order: no atomics, so results repeat bit for bit.
// The padding zeros are multiplied, not skipped (skipping them would add a
// select to every FMA of the inner loop), so Y = A X holds for finite X
// only: a non-finite X value spreads to every row of the groups that hold
// its column (0 * inf = NaN). The plain version does the same.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 4;    // rows per warp (GROUP of ops/spmm_kernel.py)
constexpr int kWarps = 4;    // groups per block (a tile of 16 rows)
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

__device__ __forceinline__ void load4(const float* p, float (&v)[kGroup]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[kGroup]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// CPT consecutive values of X through the read-only path: one load of
// CPT * sizeof(T) bytes (aligned by the caller).
template <int CPT, typename T>
__device__ __forceinline__ void load_x(const T* p, T (&v)[CPT]) {
  if constexpr (CPT == 1) {
    v[0] = __ldg(p);
  } else if constexpr (CPT * sizeof(T) == 8) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else if constexpr (sizeof(T) == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const double2 q = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = q.x; v[1] = q.y;
  }
}

// Asynchronous 16-byte copy from global to shared memory.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(src));
}

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
spmm_tile_kernel(const int32_t* __restrict__ eptr,  // (n_groups + 1,)
                 const int32_t* __restrict__ ecol,  // (E,)
                 const T* __restrict__ evals,       // (E, kGroup)
                 const T* __restrict__ x,           // (n, B)
                 T* __restrict__ y,                 // (m, B)
                 int64_t m, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g0 = blockIdx.x * kWarps;
  const int e0 = eptr[g0];
  const int ne = eptr[g0 + kWarps] - e0;
  T* vs = reinterpret_cast<T*>(smem);                                      // (ne, kGroup)
  int32_t* cs = reinterpret_cast<int32_t*>(vs + static_cast<size_t>(ne) * kGroup);  // (ne,)

  // 1. The tile's entries to shared memory (every group's count is a
  // multiple of 4, so both arrays copy in 16-byte pieces).
  constexpr int kPer16 = 16 / sizeof(T);
  const T* ev = evals + static_cast<int64_t>(e0) * kGroup;
  for (int i = threadIdx.x; i < ne * kGroup / kPer16; i += kThreads) {
    cp_async16(vs + i * kPer16, ev + i * kPer16);
  }
  for (int i = threadIdx.x; i < ne / 4; i += kThreads) {
    cp_async16(cs + i * 4, ecol + e0 + i * 4);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 2. A warp per group: kGroup rows x CPT columns per lane.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ea = eptr[g0 + warp] - e0;
  const int eb = eptr[g0 + warp + 1] - e0;
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * (32 * CPT) + lane * CPT;
  if (b0 >= B) return;  // B is a multiple of CPT: a lane's columns are all in or all out
  T acc[CPT][kGroup];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
#pragma unroll
    for (int r = 0; r < kGroup; ++r) acc[c][r] = T(0);
  }
  for (int e = ea; e < eb; e += 4) {
    const int4 c4 = *reinterpret_cast<const int4*>(cs + e);
    const int cl[4] = {c4.x, c4.y, c4.z, c4.w};
    T xv[4][CPT];
#pragma unroll
    for (int q = 0; q < 4; ++q) load_x<CPT>(x + static_cast<int64_t>(cl[q]) * B + b0, xv[q]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      T v[kGroup];
      load4(vs + (e + q) * kGroup, v);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
#pragma unroll
        for (int r = 0; r < kGroup; ++r) acc[c][r] = fma_t(v[r], xv[q][c], acc[c][r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    const int64_t row = static_cast<int64_t>(g0 + warp) * kGroup + r;
    if (row < m) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) y[row * B + b0 + c] = acc[c][r];
    }
  }
}

template <typename T, int CPT>
int launch(const int32_t* eptr, const int32_t* ecol, const T* evals,
           const T* x, T* y, int64_t m, int64_t B, int64_t n_tiles,
           int64_t smem, void* stream) {
  // Opt in to more than 48 KB of dynamic shared memory (once per size).
  static int64_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        spmm_tile_kernel<T, CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  const dim3 grid(static_cast<unsigned int>(n_tiles),
                  static_cast<unsigned int>((B + 32 * CPT - 1) / (32 * CPT)));
  spmm_tile_kernel<T, CPT><<<grid, kThreads, static_cast<size_t>(smem),
                             static_cast<cudaStream_t>(stream)>>>(
      eptr, ecol, evals, x, y, m, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const int32_t* eptr, const int32_t* ecol, const T* evals,
             const T* x, T* y, int64_t m, int64_t B, int64_t n_tiles,
             int64_t cpt, int64_t smem, void* stream) {
  if (B % cpt != 0 || cpt * static_cast<int64_t>(sizeof(T)) > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (cpt) {
    case 1:
      return launch<T, 1>(eptr, ecol, evals, x, y, m, B, n_tiles, smem, stream);
    case 2:
      return launch<T, 2>(eptr, ecol, evals, x, y, m, B, n_tiles, smem, stream);
    case 4:
      if constexpr (sizeof(T) == 4) {
        return launch<T, 4>(eptr, ecol, evals, x, y, m, B, n_tiles, smem,
                            stream);
      }
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Each launches one kernel on `stream` and returns cudaGetLastError() (or
// the error of raising the block's shared-memory limit) as an int. The
// caller allocates y (m * B values) and passes the pack's layout: n_tiles
// tiles of 16 rows, smem = bytes of dynamic shared memory of the largest
// tile; cpt = columns per lane (1, 2, or 4 in float32), with B a multiple
// of cpt and x aligned to cpt values.
int spmm_tile_f32(const int32_t* eptr, const int32_t* ecol, const float* evals,
                  const float* x, float* y, int64_t m, int64_t B,
                  int64_t n_tiles, int64_t cpt, int64_t smem, void* stream) {
  return dispatch<float>(eptr, ecol, evals, x, y, m, B, n_tiles, cpt, smem,
                         stream);
}

int spmm_tile_f64(const int32_t* eptr, const int32_t* ecol,
                  const double* evals, const double* x, double* y, int64_t m,
                  int64_t B, int64_t n_tiles, int64_t cpt, int64_t smem,
                  void* stream) {
  return dispatch<double>(eptr, ecol, evals, x, y, m, B, n_tiles, cpt, smem,
                          stream);
}

const char* spmm_tile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
