// Skeleton bake: per voxel, the nearest skeleton point of the voxel's own
// instance, by anisotropy-weighted squared distance.
//
// Replaces skoots_tpu/kernels/bake.py::_bake_call (the Pallas running
// arg-min over blocks of all points).
//
// What bounds it on the H100: the work this data needs is, for every
// foreground voxel and every point of its own instance, 3 subtractions and
// 8 multiplies / adds (at the training crop, V = 294,912 and P = 256 points
// of 8 instances: a few microseconds of FP32 work), against 4.7 MB of
// output. So a voxel must visit only its own instance's points:
//  * a block covers a compact 16 x 16 voxel tile of one x plane (a thread
//    one voxel) and first lists the tile's distinct foreground ids in
//    ascending order (rounds of a block-wide minimum). A tile with no
//    foreground writes zeros and reads no point. A thread keeps one voxel,
//    not a column of several that would reuse each loaded point: a tile
//    inside a large instance is the critical path, and small blocks spread
//    it over more SMs and keep more warps resident.
//  * With at most CAP ids, it counts each id's points, then places them in
//    shared memory, one list an id, in their original order (a ballot a id
//    per warp and the warps' counts in order: a stable compaction), and
//    each voxel scans its own id's list: no id compare, the points as
//    float4 broadcast from shared memory, the best index kept and its
//    coordinates read once at the end.
//  * A tile with more ids than CAP, or more listed points than fit, scans
//    all P points in shared-memory chunks with the id compare, in the same
//    kernel.
//
// Semantics, as the Pallas kernel and the plain version (kernels/bake.py):
//  * voxel coordinates come from the flat index of [X, Y, Z];
//  * d2 = dx*dx*wx + dy*dy*wy + dz*dz*wz, every product and sum rounded on
//    its own (__fmul_rn / __fadd_rn: nvcc would otherwise contract a*b+c
//    into an FMA, which the one-op-per-kernel plain version never does);
//  * a running strict-< minimum over the points in their original order
//    keeps the FIRST minimal point;
//  * ids of 0 are padding and never match; a voxel with no own-instance
//    point (background, or an instance without points) gets point 0 and
//    distance 0; the distance is __fsqrt_rn, rounded as torch's sqrt.
// tests/test_torch_bake_lists.py states the lists, the cap and the full
// scan in torch.
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int TY = 16, TZ = 16;    // the tile: one x plane, thread (tid / TZ, tid % TZ)
constexpr int THREADS = TY * TZ;
constexpr int WARPS = THREADS / 32;
constexpr int CAP = 8;             // distinct ids a tile lists by id
constexpr int LMAX = 4096;         // listed points a block holds (64 KB)
constexpr float BIG = 3.4e38f;

__device__ __forceinline__ float dist2(float vx, float vy, float vz, float4 p, float wx,
                                       float wy, float wz) {
  const float dx = __fsub_rn(vx, p.x);
  const float dy = __fsub_rn(vy, p.y);
  const float dz = __fsub_rn(vz, p.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(dx, dx), wx), __fmul_rn(__fmul_rn(dy, dy), wy)),
                   __fmul_rn(__fmul_rn(dz, dz), wz));
}

__global__ void __launch_bounds__(THREADS)
bake_kernel(const int* __restrict__ mask, const float* __restrict__ points,
            const int* __restrict__ ids, int P, int X, int Y, int Z, float wx, float wy,
            float wz, int lcap, float* __restrict__ baked, float* __restrict__ dist) {
  extern __shared__ float4 list[];  // [lcap]: the ids' lists, or a chunk of all points
  __shared__ int s_id[CAP], s_cnt[CAP], s_start[CAP], s_cur[CAP];
  __shared__ int s_warp[WARPS][CAP];
  __shared__ long long s_min[WARPS];
  __shared__ int s_total;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nzt = (Z + TZ - 1) / TZ, nyt = (Y + TY - 1) / TY;
  int r = blockIdx.x;
  const int zt = r % nzt;
  r /= nzt;
  const int yt = r % nyt;
  const int vx = r / nyt;
  const int vz = zt * TZ + tid % TZ, vy = yt * TY + tid / TZ;
  const bool in = vz < Z && vy < Y;
  const long long i = ((long long)vx * Y + vy) * Z + vz;
  const int m = in ? mask[i] : 0;

  // the tile's distinct foreground ids, ascending; n = CAP + 1: more
  int n = 0;
  long long last = LLONG_MIN;
  while (true) {
    long long lo = m != 0 && (long long)m > last ? m : LLONG_MAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const long long other = __shfl_xor_sync(0xffffffffu, lo, o);
      lo = other < lo ? other : lo;
    }
    if (lane == 0) s_min[warp] = lo;
    __syncthreads();
    long long b = s_min[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) b = s_min[w] < b ? s_min[w] : b;
    __syncthreads();  // s_min is written again next round
    if (b == LLONG_MAX) break;
    if (n == CAP) {
      n = CAP + 1;
      break;
    }
    if (tid == 0) s_id[n] = (int)b;
    ++n;
    last = b;
  }

  float best = BIG, bx = 0.f, by = 0.f, bz = 0.f;
  const float fx = (float)vx, fy = (float)vy, fz = (float)vz;
  // the list slot of an id, -1 for none (padding 0 is never listed)
  auto slot_of = [&](int id) {
    int s = -1;
    for (int k = 0; k < n; ++k)
      if (s_id[k] == id) s = k;
    return s;
  };

  bool listed = n > 0 && n <= CAP;
  if (listed) {
    if (tid < CAP) s_cnt[tid] = 0;
    __syncthreads();  // s_id and s_cnt
    for (int p0 = 0; p0 < P; p0 += THREADS) {
      const int j = p0 + tid;
      const int s = j < P ? slot_of(ids[j]) : -1;
      if (s >= 0) atomicAdd(&s_cnt[s], 1);  // integer counts: any order gives the same
    }
    __syncthreads();
    if (tid == 0) {
      int t = 0;
      for (int s = 0; s < n; ++s) {
        s_start[s] = s_cur[s] = t;
        t += s_cnt[s];
      }
      s_total = t;
    }
    __syncthreads();
    listed = s_total <= lcap;
  }
  if (listed) {
    // place each listed point at its id's cursor + the points of the same
    // id before it in this chunk (earlier warps, then earlier lanes)
    for (int p0 = 0; p0 < P; p0 += THREADS) {
      const int j = p0 + tid;
      const int s = j < P ? slot_of(ids[j]) : -1;
      int rank = 0;
      for (int k = 0; k < n; ++k) {
        const unsigned bal = __ballot_sync(0xffffffffu, s == k);
        if (lane == 0) s_warp[warp][k] = __popc(bal);
        if (s == k) rank = __popc(bal & ((1u << lane) - 1u));
      }
      __syncthreads();
      if (s >= 0) {
        int off = s_cur[s] + rank;
        for (int w = 0; w < warp; ++w) off += s_warp[w][s];
        list[off] = make_float4(points[3LL * j], points[3LL * j + 1], points[3LL * j + 2], 0.f);
      }
      __syncthreads();
      if (tid < n) {
        int a = 0;
        for (int w = 0; w < WARPS; ++w) a += s_warp[w][tid];
        s_cur[tid] += a;
      }
      __syncthreads();
    }
    const int sl = m != 0 ? slot_of(m) : -1;
    if (sl >= 0) {
      int bidx = 0;
      const int k1 = s_start[sl] + s_cnt[sl];
      for (int k = s_start[sl]; k < k1; ++k) {
        const float d2 = dist2(fx, fy, fz, list[k], wx, wy, wz);
        if (d2 < best) {
          best = d2;
          bidx = k;
        }
      }
      if (best < BIG) {
        const float4 p = list[bidx];
        bx = p.x;
        by = p.y;
        bz = p.z;
      }
    }
  } else if (n > 0) {
    // over the cap: every point, chunk by chunk, with the id compare
    for (int p0 = 0; p0 < P; p0 += lcap) {
      const int cnt = min(lcap, P - p0);
      __syncthreads();
      for (int j = tid; j < cnt; j += THREADS) {
        const long long q = p0 + j;
        list[j] = make_float4(points[3 * q], points[3 * q + 1], points[3 * q + 2],
                              __int_as_float(ids[q]));
      }
      __syncthreads();
      if (m == 0) continue;
      for (int k = 0; k < cnt; ++k) {
        const float4 p = list[k];
        if (__float_as_int(p.w) != m) continue;
        const float d2 = dist2(fx, fy, fz, p, wx, wy, wz);
        if (d2 < best) {
          best = d2;
          bx = p.x;
          by = p.y;
          bz = p.z;
        }
      }
    }
  }

  if (!in) return;
  const bool found = best < BIG;
  baked[i * 3 + 0] = found ? bx : 0.f;
  baked[i * 3 + 1] = found ? by : 0.f;
  baked[i * 3 + 2] = found ? bz : 0.f;
  dist[i] = found ? __fsqrt_rn(fmaxf(best, 0.f)) : 0.f;
}

}  // namespace

// mask: int32 [X, Y, Z]; points: f32 [P, 3]; ids: int32 [P] (0 = padding);
// baked: f32 [X, Y, Z, 3]; dist: f32 [X, Y, Z].
extern "C" int skoots_bake(const void* mask, const void* points,
                           const void* ids, int P, int X, int Y, int Z,
                           float wx, float wy, float wz, void* baked,
                           void* dist, void* stream) {
  const long long blocks = (long long)X * ((Y + TY - 1) / TY) * ((Z + TZ - 1) / TZ);
  if ((long long)X * Y * Z <= 0 || blocks > 0x7fffffffLL || P < 0)
    return (int)cudaErrorInvalidValue;
  // the list holds every point when it can (at least a chunk of THREADS)
  const int lcap = P < THREADS ? THREADS : (P < LMAX ? (P + 31) / 32 * 32 : LMAX);
  const int smem = lcap * (int)sizeof(float4);
  // the largest list the kernel may be given, once a device
  static int ready_for = -1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (ready_for != dev) {
    e = cudaFuncSetAttribute(bake_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             LMAX * (int)sizeof(float4));
    if (e != cudaSuccess) return (int)e;
    ready_for = dev;
  }
  bake_kernel<<<(unsigned)blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(mask), static_cast<const float*>(points),
      static_cast<const int*>(ids), P, X, Y, Z, wx, wy, wz, lcap,
      static_cast<float*>(baked), static_cast<float*>(dist));
  return (int)cudaGetLastError();
}
