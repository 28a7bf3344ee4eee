// Sparse times dense, Y = A X, for Hopper (sm_90a), in float32 and float64.
//
// Replaces the TPU kernel optconpy_tpu/ops/pallas_spmm.py::windowed_dense_spmm.
// That kernel stored each 128-row tile of an RCM-ordered FEM operator as a
// dense (128, w) block over a column window and ran one matrix-unit product
// per tile; at the refinement-2 cylinder (A~^T: 15,316 rows, window 1,008) that
// is about 46x the arithmetic of the nonzeros, which the TPU's matrix unit
// absorbed. Here the same product runs on the CUDA cores, so this kernel
// computes from the nonzeros only.
//
// Layout: A in padded ELL, rows in the caller's (RCM) order: vals (m, k),
// cols (m, k) int32, row_nnz (m,) int32 with the row's real entries in slots
// [0, row_nnz); X (n, B) and Y (m, B) row-major.
//
// What bounds it on the H100: memory. At the NS build's width (B = 17,396)
// X is read once (1.07 GB for A~^T in float32) and Y written once, against
// 2 flop per nonzero and column (0.18 ms of the 0.64 ms bound). The design:
//   - one block = kRows rows x one tile of columns. The block stages its
//     rows' (value, column) pairs in shared memory, where every thread reads
//     the same word (broadcast);
//   - each thread owns one column and sums the row's nonzeros in slot order:
//     no atomics, so the result repeats bit for bit. Padding slots are
//     skipped through row_nnz;
//   - neighbouring threads read neighbouring columns of each gathered X row,
//     so loads and stores coalesce;
//   - blockIdx.x (row tiles) runs fastest, so the blocks in flight share one
//     column tile: the X rows they gather lie in one RCM window (about
//     1,008 rows x 128 columns x 4 B = 0.5 MB), which stays in the 50 MB L2,
//     and X comes from device memory about once;
//   - narrow B (1 probe column, 8 probe columns) uses 32-column tiles with
//     4 rows in parallel, so fewer threads idle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;  // rows of A per block

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spmm_ell_kernel(const T* __restrict__ vals,          // (m, k)
                const int32_t* __restrict__ cols,    // (m, k)
                const int32_t* __restrict__ row_nnz, // (m,)
                const T* __restrict__ x,             // (n, B)
                T* __restrict__ y,                   // (m, B)
                int64_t m, int64_t k, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sv = reinterpret_cast<T*>(smem);                         // (kRows, k)
  int32_t* sc = reinterpret_cast<int32_t*>(sv + kRows * k);  // (kRows, k)
  __shared__ int32_t snnz[kRows];

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(m - r0 < kRows ? m - r0 : kRows);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int64_t t = tid; t < rows * k; t += nthreads) {
    sv[t] = vals[r0 * k + t];
    sc[t] = cols[r0 * k + t];
  }
  if (tid < rows) snnz[tid] = row_nnz[r0 + tid];
  __syncthreads();

  const int64_t b = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (b >= B) return;  // ragged last column tile
  for (int r = threadIdx.y; r < rows; r += blockDim.y) {
    const T* v = sv + r * k;
    const int32_t* c = sc + r * k;
    const int nnz = snnz[r];
    T acc = T(0);
#pragma unroll 4
    for (int s = 0; s < nnz; ++s) {
      acc = fma_t(v[s], x[static_cast<int64_t>(c[s]) * B + b], acc);
    }
    y[(r0 + r) * B + b] = acc;
  }
}

template <typename T>
int launch(const T* vals, const int32_t* cols, const int32_t* row_nnz,
           const T* x, T* y, int64_t m, int64_t k, int64_t B, void* stream) {
  // Column tile: 128 columns, or 32 columns x 4 rows in parallel at B <= 32.
  const unsigned int tx = B > 32 ? 128 : 32;
  const dim3 block(tx, kThreads / tx);
  const dim3 grid(static_cast<unsigned int>((m + kRows - 1) / kRows),
                  static_cast<unsigned int>((B + tx - 1) / tx));
  const size_t smem = static_cast<size_t>(kRows) * k * (sizeof(T) + sizeof(int32_t));
  spmm_ell_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      vals, cols, row_nnz, x, y, m, k, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launches one kernel on `stream` and returns cudaGetLastError() as an
// int. The caller allocates y (m * B values) and checks that the block's
// kRows * k * (sizeof(T) + 4) bytes of dynamic shared memory fit the 48 KB
// a block may use without opting in.
int spmm_ell_f32(const float* vals, const int32_t* cols, const int32_t* row_nnz,
                 const float* x, float* y, int64_t m, int64_t k, int64_t B,
                 void* stream) {
  return launch<float>(vals, cols, row_nnz, x, y, m, k, B, stream);
}

int spmm_ell_f64(const double* vals, const int32_t* cols,
                 const int32_t* row_nnz, const double* x, double* y, int64_t m,
                 int64_t k, int64_t B, void* stream) {
  return launch<double>(vals, cols, row_nnz, x, y, m, k, B, stream);
}

const char* spmm_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
