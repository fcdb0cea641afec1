// Skeleton bake: per voxel, the nearest skeleton point of the voxel's own
// instance, by anisotropy-weighted squared distance.
//
// Replaces skoots_tpu/kernels/bake.py::_bake_call (the Pallas running
// arg-min). The original SKOOTS runs the same op as one GPU program per
// voxel; so does this kernel: one thread per voxel.
//
// What bounds it on the H100: each voxel scans all P points (a compare and,
// for own-instance points, 3 subtractions and 8 multiplies/adds): at the
// training crop (V = 294,912, P = 256) that is ~75 M point visits, a few
// microseconds of FP32 work, against 4.7 MB of output -- small either way.
// Points and ids are staged in shared memory a block at a time, so every
// thread of a block reads them from there, not from device memory.
//
// Semantics, as the Pallas kernel and the plain version (kernels/bake.py):
//  * voxel coordinates come from the flat index of [X, Y, Z];
//  * d2 = dx*dx*wx + dy*dy*wy + dz*dz*wz, every product and sum rounded on
//    its own (__fmul_rn / __fadd_rn: nvcc would otherwise contract a*b+c
//    into an FMA, which the one-op-per-kernel plain version never does);
//  * a running strict-< minimum keeps the FIRST minimal point;
//  * ids of 0 are padding and never match; a voxel with no own-instance
//    point (background, or an instance without points) gets point 0 and
//    distance 0; the distance is __fsqrt_rn, rounded as torch's sqrt.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // voxels per block
constexpr int PB = 256;       // points staged per step
constexpr float BIG = 3.4e38f;

__global__ void __launch_bounds__(THREADS)
bake_kernel(const int* __restrict__ mask, const float* __restrict__ points,
            const int* __restrict__ ids, int P, int X, int Y, int Z, float wx,
            float wy, float wz, float* __restrict__ baked,
            float* __restrict__ dist) {
  __shared__ float spx[PB], spy[PB], spz[PB];
  __shared__ int sid[PB];
  const long long V = (long long)X * Y * Z;
  const long long v = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int m = v < V ? mask[v] : 0;
  const float vz = (float)(v % Z);
  const float vy = (float)((v / Z) % Y);
  const float vx = (float)(v / ((long long)Z * Y));

  float best = BIG, bx = 0.f, by = 0.f, bz = 0.f;
  for (int p0 = 0; p0 < P; p0 += PB) {
    const int n = min(PB, P - p0);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += THREADS) {
      spx[j] = points[(long long)(p0 + j) * 3 + 0];
      spy[j] = points[(long long)(p0 + j) * 3 + 1];
      spz[j] = points[(long long)(p0 + j) * 3 + 2];
      sid[j] = ids[p0 + j];
    }
    __syncthreads();
    if (m == 0) continue;  // background: nothing matches
    for (int j = 0; j < n; ++j) {
      if (sid[j] != m) continue;
      const float dx = __fsub_rn(vx, spx[j]);
      const float dy = __fsub_rn(vy, spy[j]);
      const float dz = __fsub_rn(vz, spz[j]);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(dx, dx), wx),
                    __fmul_rn(__fmul_rn(dy, dy), wy)),
          __fmul_rn(__fmul_rn(dz, dz), wz));
      if (d2 < best) {
        best = d2;
        bx = spx[j];
        by = spy[j];
        bz = spz[j];
      }
    }
  }
  if (v >= V) return;
  const bool found = best < BIG;
  baked[v * 3 + 0] = found ? bx : 0.f;
  baked[v * 3 + 1] = found ? by : 0.f;
  baked[v * 3 + 2] = found ? bz : 0.f;
  dist[v] = found ? __fsqrt_rn(fmaxf(best, 0.f)) : 0.f;
}

}  // namespace

// mask: int32 [X, Y, Z]; points: f32 [P, 3]; ids: int32 [P] (0 = padding);
// baked: f32 [X, Y, Z, 3]; dist: f32 [X, Y, Z].
extern "C" int skoots_bake(const void* mask, const void* points,
                           const void* ids, int P, int X, int Y, int Z,
                           float wx, float wy, float wz, void* baked,
                           void* dist, void* stream) {
  const long long V = (long long)X * Y * Z;
  const long long blocks = (V + THREADS - 1) / THREADS;
  if (V <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bake_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(mask), static_cast<const float*>(points),
      static_cast<const int*>(ids), P, X, Y, Z, wx, wy, wz,
      static_cast<float*>(baked), static_cast<float*>(dist));
  return (int)cudaGetLastError();
}
