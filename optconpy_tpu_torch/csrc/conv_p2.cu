// Batched P2 Taylor-Hood convection N(v)v on the free dofs, for Hopper (sm_90a).
//
// Replaces the TPU kernel optconpy_tpu/ops/pallas_conv.py::conv_element_blocks
// together with the XLA gather and scatter around it (conv_full_batch_pallas)
// and the inner/full bookkeeping of ConvKernel.conv_inner_batch:
// (n_free, B) float32 batch-last free-dof velocities in, (n_free, B) out.
//
// Per element e and scenario column b, with v_c[j] the velocity component c
// at the element's local P2 node j (a free dof or a Dirichlet value):
//   W[i][k]  = sum_{j,c} T0[e][i][j][k][c] * v_c[j]        36 sums of 12 terms
//   out_a[i] = sum_k W[i][k] * v_a[k]                      a in {x, y}
// which is 1008 flop per element and column; the element results are then
// summed into their scalar dofs.
//
// What bounds it on the H100: operations. At the cylinder's bench shape
// (nt = 1155, n_free = 4396, B = 1024) a call needs 1.19 GFLOP (17.8 us at
// 67 TFLOP/s) and 38 MB of reads and writes (11 us). The first port took
// 104.8 us: its element kernel read each T0 value from shared memory for one
// pair of FMAs, and it wrote 57 MB of per-element results to device memory
// for a second launch to sum, while the caller built the full (2*ns, B) batch
// and gathered the free rows around it. The design:
//   1. register blocking: a warp computes one element for 64 columns, two per
//      lane (strided by 32, so loads and stores coalesce), and each T0 value
//      read from shared memory (three 16-byte reads per (i, j)) feeds four
//      FMAs. The next element's T0 and nodal values are loaded into
//      registers while the current one computes;
//   2. element results stay on chip: a block owns a patch of up to kPatch
//      elements that share dofs (the host cuts the mesh) x a tile of kCols
//      columns. Its elements' results go to shared memory; then a warp per
//      patch dof sums the dof's element slots there in a fixed order, for
//      both components and the lane's columns, reading the slot list (CSR)
//      and destination from shared memory (copied while the elements
//      compute). A dof whose elements all lie in the patch is written to its
//      free row directly; a dof that patches share leaves its patch sum in a
//      small buffer, and a second, short kernel adds those in patch order.
//      No atomics, so the result repeats bit for bit. Patches of 24 elements
//      leave room for two blocks on an SM; on the H100 they ran faster than
//      patches of 8 to 32;
//   3. the inner/full map is in the kernel: nodes read their free row or
//      their Dirichlet value through the host's map, and only free rows are
//      written, so the caller launches nothing else.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNodes = 6;
constexpr int kT0 = 432;       // 6 * 6 * 6 * 2 floats per element: T0[i][j][k][c]
constexpr int kPatch = 24;     // most elements of a patch (PATCH of ops/conv_kernel.py)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPer = 2;        // columns per lane, strided by 32
constexpr int kCols = 32 * kPer;  // columns per block
constexpr int kStage = kPatch * kNodes * 2 * kCols;  // floats of element results

// Asynchronous 4-byte copy from global to shared memory.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(s), "l"(src));
}

__global__ void __launch_bounds__(kThreads, 2)
conv_p2_patch_kernel(const float* __restrict__ v,       // (n_free, B)
                     const float* __restrict__ t0,      // (nt, 432)
                     const int32_t* __restrict__ vsrc,  // (nt, 12)
                     const float* __restrict__ vdir,    // (nt, 12)
                     const int32_t* __restrict__ pelem, // (n_patches, kPatch)
                     const int32_t* __restrict__ pnd,   // (n_patches,)
                     const int16_t* __restrict__ pslot, // (n_patches, kPatch*6)
                     const int32_t* __restrict__ psptr, // (n_patches, nd + 1)
                     const int32_t* __restrict__ pdst,  // (n_patches, nd, 2)
                     float* __restrict__ out,           // (n_free, B)
                     float* __restrict__ part,          // (n_part, B)
                     int64_t B, int nd) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                                    // (kPatch*6*2, kCols)
  float* t0s = smem + kStage + (threadIdx.x / 32) * kT0;  // this warp's element
  int32_t* dsts = reinterpret_cast<int32_t*>(smem + kStage + kWarps * kT0);  // (nd, 2)
  int32_t* sptr = dsts + nd * 2;                                       // (nd + 1,)
  int16_t* slots = reinterpret_cast<int16_t*>(sptr + nd + 1);          // (kPatch*6,)
  const int p = blockIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kCols;
  const int lane = threadIdx.x % 32;

  // 0. The patch's dof maps to shared memory, in flight during step 1 (the
  // slot lists copy as int16 pairs).
  for (int i = threadIdx.x; i < nd * 2; i += kThreads) {
    cp_async4(dsts + i, pdst + static_cast<int64_t>(p) * nd * 2 + i);
  }
  for (int i = threadIdx.x; i <= nd; i += kThreads) {
    cp_async4(sptr + i, psptr + static_cast<int64_t>(p) * (nd + 1) + i);
  }
  const int32_t* sl_pairs =
      reinterpret_cast<const int32_t*>(pslot + static_cast<int64_t>(p) * kPatch * kNodes);
  for (int i = threadIdx.x; i < kPatch * kNodes / 2; i += kThreads) {
    cp_async4(reinterpret_cast<int32_t*>(slots) + i, sl_pairs + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // 1. One warp per element; the next element's T0 and nodal values are
  // loaded into registers while the current one computes.
  constexpr int kT0Lane = (kT0 + 31) / 32;
  float tr[kT0Lane], px[kPer][kNodes], py[kPer][kNodes];
  auto load_elem = [&](int e) {
#pragma unroll
    for (int k = 0; k < kT0Lane; ++k) {
      const int t = lane + 32 * k;
      tr[k] = t < kT0 ? t0[static_cast<int64_t>(e) * kT0 + t] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kNodes; ++j) {
      const int sx = vsrc[e * 12 + j * 2];
      const int sy = vsrc[e * 12 + j * 2 + 1];
      const float dx = vdir[e * 12 + j * 2];
      const float dy = vdir[e * 12 + j * 2 + 1];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int64_t b = c0 + lane + 32 * q;
        const bool ok = b < B;
        px[q][j] = sx >= 0 ? (ok ? v[sx * B + b] : 0.f) : dx;
        py[q][j] = sy >= 0 ? (ok ? v[sy * B + b] : 0.f) : dy;
      }
    }
  };
  int el = threadIdx.x / 32;
  int e = el < kPatch ? pelem[p * kPatch + el] : -1;
  if (e >= 0) load_elem(e);
  while (e >= 0) {
#pragma unroll
    for (int k = 0; k < kT0Lane; ++k) {
      const int t = lane + 32 * k;
      if (t < kT0) t0s[t] = tr[k];
    }
    float vx[kPer][kNodes], vy[kPer][kNodes];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
#pragma unroll
      for (int j = 0; j < kNodes; ++j) {
        vx[q][j] = px[q][j];
        vy[q][j] = py[q][j];
      }
    }
    __syncwarp();
    const int el_next = el + kWarps;
    const int e_next = el_next < kPatch ? pelem[p * kPatch + el_next] : -1;
    if (e_next >= 0) load_elem(e_next);
#pragma unroll 1
    for (int i = 0; i < kNodes; ++i) {
      float w[kPer][kNodes];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
#pragma unroll
        for (int k = 0; k < kNodes; ++k) w[q][k] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kNodes; ++j) {
        const float4* tp = reinterpret_cast<const float4*>(t0s + (i * kNodes + j) * 12);
        const float4 a0 = tp[0], a1 = tp[1], a2 = tp[2];
        const float tk[12] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y,
                              a1.z, a1.w, a2.x, a2.y, a2.z, a2.w};
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
#pragma unroll
          for (int k = 0; k < kNodes; ++k) {
            w[q][k] = fmaf(tk[2 * k], vx[q][j], w[q][k]);
            w[q][k] = fmaf(tk[2 * k + 1], vy[q][j], w[q][k]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        float ox = 0.f, oy = 0.f;
#pragma unroll
        for (int k = 0; k < kNodes; ++k) {
          ox = fmaf(w[q][k], vx[q][k], ox);
          oy = fmaf(w[q][k], vy[q][k], oy);
        }
        float* row = stage + ((el * kNodes + i) * 2) * kCols + lane + 32 * q;
        row[0] = ox;
        row[kCols] = oy;
      }
    }
    __syncwarp();  // the next element overwrites t0s
    el = el_next;
    e = e_next;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 2. A warp per patch dof: each lane sums both components of its kPer
  // columns over the dof's element slots, in slot order.
  const int n = pnd[p];
  for (int k = threadIdx.x / 32; k < n; k += kWarps) {
    float s[2][kPer];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) s[a][q] = 0.f;
    }
    for (int t = sptr[k]; t < sptr[k + 1]; ++t) {
      const float* src = stage + slots[t] * 2 * kCols + lane;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int q = 0; q < kPer; ++q) s[a][q] += src[a * kCols + 32 * q];
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int dst = dsts[k * 2 + a];
      if (dst == -1) continue;  // a Dirichlet dof
      float* row = dst >= 0 ? out + static_cast<int64_t>(dst) * B
                            : part + static_cast<int64_t>(-2 - dst) * B;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int64_t b = c0 + lane + 32 * q;
        if (b < B) row[b] = s[a][q];
      }
    }
  }
}

__global__ void __launch_bounds__(128)
conv_p2_shared_dofs_kernel(const float* __restrict__ part,     // (n_part, B)
                           const int32_t* __restrict__ bdst,   // (n_bnd,)
                           const int32_t* __restrict__ bsrc,   // (n_bnd, kp)
                           float* __restrict__ out,            // (n_free, B)
                           int64_t B, int kp) {
  const int64_t r = blockIdx.x;
  const int64_t b = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float s = 0.f;
#pragma unroll 4
  for (int q = 0; q < kp; ++q) {  // the padding, -1, comes last
    const int src = bsrc[r * kp + q];
    if (src >= 0) s += part[static_cast<int64_t>(src) * B + b];
  }
  out[static_cast<int64_t>(bdst[r]) * B + b] = s;
}

}  // namespace

extern "C" {

// Launches both kernels on `stream`; returns cudaGetLastError() (or the
// error of raising the patch kernel's shared-memory limit) as an int. The
// caller allocates out (n_free * B floats) and part (n_part * B floats).
int conv_p2_forward(const float* v, const float* t0, const int32_t* vsrc,
                    const float* vdir, const int32_t* pelem,
                    const int32_t* pnd, const int16_t* pslot,
                    const int32_t* psptr, const int32_t* pdst, const int32_t* bdst,
                    const int32_t* bsrc, float* out, float* part, int64_t B,
                    int64_t n_patches, int64_t nd, int64_t n_bnd, int64_t kp,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (kStage + kWarps * kT0) * sizeof(float) +
                      (nd * 2 + nd + 1) * sizeof(int32_t) +
                      kPatch * kNodes * sizeof(int16_t);
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_p2_patch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  const unsigned int col_tiles = static_cast<unsigned int>((B + kCols - 1) / kCols);
  conv_p2_patch_kernel<<<dim3(static_cast<unsigned int>(n_patches), col_tiles),
                         kThreads, smem, st>>>(
      v, t0, vsrc, vdir, pelem, pnd, pslot, psptr, pdst, out, part, B,
      static_cast<int>(nd));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_bnd == 0) return static_cast<int>(err);
  conv_p2_shared_dofs_kernel<<<dim3(static_cast<unsigned int>(n_bnd),
                                    static_cast<unsigned int>((B + 127) / 128)),
                               128, 0, st>>>(part, bdst, bsrc, out, B,
                                             static_cast<int>(kp));
  return static_cast<int>(cudaGetLastError());
}

const char* conv_p2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
