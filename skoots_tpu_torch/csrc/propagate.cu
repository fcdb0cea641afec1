// One masked label-propagation pass for connected components:
//     out[v] = fg[v] ? max(labels over the 3^3 (26-conn) or 6-face + self
//                          neighbourhood of v) : 0,
// with zero fill outside the volume; int32 labels, uint8 foreground.
//
// Replaces skoots_tpu/kernels/propagate.py::propagate_pallas, which runs Q
// such passes per call on x-slabs held in VMEM. Here one launch is one pass
// and the Python wrapper ping-pongs two buffers Q times; the result equals Q
// plain passes bit for bit (max is exact).
//
// What bounds it on the H100: a pass is pure traffic -- read 4 B of labels
// and 1 B of foreground, write 4 B, per voxel (~1.2 GB at 512^3, ~0.4 ms at
// 3.35 TB/s). The design reads each label from device memory about once:
// a block stages its (TX+2) x (TY+2) x (TZ+2) halo tile in shared memory
// with z (the contiguous axis) fastest, so loads and stores are coalesced,
// and the 27 neighbour reads come from shared memory. Fusing Q passes per
// launch with a Q-voxel halo (the TPU kernel's scheme) is the next step.
#include "common.cuh"

namespace {

constexpr int TX = 4;
constexpr int TY = 8;
constexpr int TZ = 32;
constexpr int THREADS = 256;
constexpr int SX = TX + 2, SY = TY + 2, SZ = TZ + 2;

template <bool CONN26>
__global__ void __launch_bounds__(THREADS)
propagate_kernel(const int32_t* __restrict__ in, const uint8_t* __restrict__ fg,
                 int32_t* __restrict__ out, int X, int Y, int Z) {
  __shared__ int32_t s[SX * SY * SZ];
  const int nzb = (Z + TZ - 1) / TZ;
  const int z0 = (blockIdx.x % nzb) * TZ;
  const int y0 = (blockIdx.x / nzb) * TY;
  const int x0 = blockIdx.y * TX;
  for (int i = threadIdx.x; i < SX * SY * SZ; i += THREADS) {
    const int sz = i % SZ;
    const int sy = (i / SZ) % SY;
    const int sx = i / (SZ * SY);
    const int gx = x0 + sx - 1, gy = y0 + sy - 1, gz = z0 + sz - 1;
    int32_t v = 0;
    if (gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z)
      v = in[((long long)gx * Y + gy) * Z + gz];
    s[i] = v;
  }
  __syncthreads();
  const int tz = threadIdx.x % TZ;
  const int ty = threadIdx.x / TZ;  // THREADS / TZ == TY
  const int gy = y0 + ty, gz = z0 + tz;
  if (gy >= Y || gz >= Z) return;
#pragma unroll
  for (int tx = 0; tx < TX; ++tx) {
    const int gx = x0 + tx;
    if (gx >= X) break;
    const long long g = ((long long)gx * Y + gy) * Z + gz;
    int32_t m = 0;
    if (fg[g]) {
      const int32_t* c = s + ((tx + 1) * SY + (ty + 1)) * SZ + (tz + 1);
      if (CONN26) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx)
#pragma unroll
          for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
            for (int dz = -1; dz <= 1; ++dz)
              m = max(m, c[(dx * SY + dy) * SZ + dz]);
      } else {
        m = max(c[0], max(max(c[-SY * SZ], c[SY * SZ]),
                          max(max(c[-SZ], c[SZ]), max(c[-1], c[1]))));
      }
    }
    out[g] = m;
  }
}

}  // namespace

// labels_in, labels_out: int32 [X, Y, Z]; fg: uint8 [X, Y, Z] (0 or not).
extern "C" int skoots_propagate(const void* labels_in, const void* fg,
                                void* labels_out, int X, int Y, int Z,
                                int connectivity, void* stream) {
  dim3 grid(((Z + TZ - 1) / TZ) * ((Y + TY - 1) / TY), (X + TX - 1) / TX);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* in = static_cast<const int32_t*>(labels_in);
  const uint8_t* f = static_cast<const uint8_t*>(fg);
  int32_t* o = static_cast<int32_t*>(labels_out);
  if (connectivity == 26)
    propagate_kernel<true><<<grid, THREADS, 0, s>>>(in, f, o, X, Y, Z);
  else if (connectivity == 6)
    propagate_kernel<false><<<grid, THREADS, 0, s>>>(in, f, o, X, Y, Z);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
