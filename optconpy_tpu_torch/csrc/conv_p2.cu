// Batched P2 Taylor-Hood convection N(v)v for Hopper (sm_90a).
//
// Replaces the TPU kernel optconpy_tpu/ops/pallas_conv.py::conv_element_blocks
// together with the XLA gather and scatter around it (conv_full_batch_pallas):
// (2*ns, B) float32 batch-last velocities in, (2*ns, B) weak-form vectors out.
//
// Per element e and scenario column b, with v_c[j] the velocity component c
// at the element's local P2 node j:
//   W[i][k]  = sum_{j,c} T0[e][i][j][k][c] * v_c[j]        36 sums of 12 terms
//   out_a[i] = sum_k W[i][k] * v_a[k]                      a in {x, y}
// which is 1008 flop per element and column. The element results are then
// summed into their scalar dofs.
//
// What bounds it on the H100: memory. At the cylinder's bench shape
// (nt = 1155, ns = 2437, B = 1024) a call reads v (20 MB) and T0 (2 MB),
// writes and reads back the per-element results (57 MB) and writes the result
// (20 MB), against about 1.2 GFLOP. The design keeps it simple and right:
//   1. conv_p2_element_kernel: one thread per (element, column). The gather of
//      the 12 nodal values is fused in (the TPU kernel could not gather), and
//      neighbouring threads read neighbouring columns of each gathered row, so
//      every load and store is coalesced. The block stages its element's 432
//      T0 values in shared memory, where all threads read the same word
//      (broadcast, no bank conflicts). W stays in registers.
//   2. conv_p2_slot_sum_kernel: each scalar dof sums its k_s element slots in
//      a fixed order. No atomics, so the result repeats bit for bit.
// Keeping the element results out of device memory (for example by
// colouring the mesh) is left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNodes = 6;
constexpr int kT0 = 432;  // 6 * 6 * 6 * 2 floats per element: T0[i][j][k][c]
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
conv_p2_element_kernel(const float* __restrict__ v,        // (2*ns, B)
                       const float* __restrict__ t0,       // (nt, 432)
                       const int64_t* __restrict__ dofs,   // (nt, 6)
                       float* __restrict__ elem_out,       // (2, nt*6, B)
                       int64_t nt, int64_t ns, int64_t B) {
  __shared__ float t0s[kT0];
  __shared__ int64_t dof[kNodes];
  const int64_t e = blockIdx.x;
  for (int t = threadIdx.x; t < kT0; t += blockDim.x) {
    t0s[t] = t0[e * kT0 + t];
  }
  if (threadIdx.x < kNodes) {
    dof[threadIdx.x] = dofs[e * kNodes + threadIdx.x];
  }
  __syncthreads();

  const int64_t b = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (b >= B) return;  // ragged last column block

  float vx[kNodes], vy[kNodes];
#pragma unroll
  for (int j = 0; j < kNodes; ++j) {
    vx[j] = v[dof[j] * B + b];
    vy[j] = v[(ns + dof[j]) * B + b];
  }

  float* out_x = elem_out;
  float* out_y = elem_out + nt * kNodes * B;
#pragma unroll
  for (int i = 0; i < kNodes; ++i) {
    float ox = 0.f, oy = 0.f;
#pragma unroll
    for (int k = 0; k < kNodes; ++k) {
      float w = 0.f;
#pragma unroll
      for (int j = 0; j < kNodes; ++j) {
        const float* tp = &t0s[((i * kNodes + j) * kNodes + k) * 2];
        w = fmaf(tp[0], vx[j], w);
        w = fmaf(tp[1], vy[j], w);
      }
      ox = fmaf(w, vx[k], ox);
      oy = fmaf(w, vy[k], oy);
    }
    const int64_t row = e * kNodes + i;
    out_x[row * B + b] = ox;
    out_y[row * B + b] = oy;
  }
}

__global__ void __launch_bounds__(kThreads)
conv_p2_slot_sum_kernel(const float* __restrict__ elem_out,  // (2, nt*6, B)
                        const int64_t* __restrict__ slots,   // (ns, k_s)
                        float* __restrict__ out,             // (2*ns, B)
                        int64_t nt, int64_t ns, int64_t k_s, int64_t B) {
  const int64_t row = blockIdx.x;  // a * ns + s
  const int64_t a = row / ns;
  const int64_t s = row - a * ns;
  const int64_t b = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t sentinel = nt * kNodes;  // padding slot: contributes nothing
  const float* src = elem_out + a * sentinel * B;
  float acc = 0.f;
  for (int64_t t = 0; t < k_s; ++t) {
    const int64_t slot = slots[s * k_s + t];
    if (slot < sentinel) acc += src[slot * B + b];
  }
  out[row * B + b] = acc;
}

}  // namespace

extern "C" {

// Launches both kernels on `stream`; returns cudaGetLastError() as an int.
// The caller allocates elem_out (2 * nt * 6 * B floats) and out (2 * ns * B).
int conv_p2_forward(const float* v, const float* t0, const int64_t* dofs,
                    const int64_t* slots, float* elem_out, float* out,
                    int64_t nt, int64_t ns, int64_t k_s, int64_t B,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int col_blocks =
      static_cast<unsigned int>((B + kThreads - 1) / kThreads);
  conv_p2_element_kernel<<<dim3(static_cast<unsigned int>(nt), col_blocks),
                           kThreads, 0, st>>>(v, t0, dofs, elem_out, nt, ns, B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_p2_slot_sum_kernel<<<dim3(static_cast<unsigned int>(2 * ns), col_blocks),
                            kThreads, 0, st>>>(elem_out, slots, out, nt, ns, k_s,
                                               B);
  return static_cast<int>(cudaGetLastError());
}

const char* conv_p2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
