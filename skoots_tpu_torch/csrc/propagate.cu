// Masked label propagation for connected components, q <= QMAX passes a
// launch:
//     out[v] = fg[v] ? max(labels over the 3^3 (26-conn) or 6-face + self
//                          neighbourhood of v) : 0,
// applied q times, with zero fill outside the volume; int32 labels, uint8
// foreground. The result equals q plain passes bit for bit (max is exact).
//
// Replaces skoots_tpu/kernels/propagate.py::propagate_pallas, which runs Q
// passes per call on x-slabs held in VMEM behind a Q-row x-halo. A block of
// the H100 has 227 KB of shared memory, not a slab of VMEM, so here the
// halo is QMAX voxels deep on every side in all three axes:
//
// * Tile. A block owns a TX x TY x TZ interior and holds it with its halo,
//   SX x SY x SZ = (TX + 2 QMAX) x (TY + 2 QMAX) x 32 VZ voxels, in the
//   registers of its threads: one warp per halo row y, lane l holding
//   z = l VZ .. l VZ + VZ - 1 of that row for all SX planes x, with the
//   plane's foreground as one bit of a word. A warp loads 32 VZ consecutive
//   int32 of a plane (coalesced along z, the contiguous axis); labels and
//   foreground outside the volume load as 0.
// * A pass. The x neighbours lie in the thread's own registers, the z
//   neighbours in the lanes beside it (shuffles), the y neighbours in the
//   warps above and below: every warp writes its SX x SZ values to shared
//   memory, one barrier, and reads its two neighbour rows. Two buffers
//   alternate between passes, so one barrier a pass suffices. 26-conn takes
//   separable maxima (x, then z, then y); 6-conn the pass input's self and
//   six faces. Every pass masks the whole halo tile by its foreground.
// * Exactness. A voxel on a face of the halo tile lacks its outside
//   neighbours (it takes a value from inside the tile instead), so after
//   pass p the values within p voxels of the faces are wrong and everything
//   deeper is exact: with q <= QMAX the interior is. Only the interior is
//   written.
// * Skip. The foreground is fixed within a call, and a tile whose interior
//   has none outputs zeros whatever the labels. Once a call, a helper
//   kernel (tile_list_kernel: a block a tile reads the interior's
//   foreground, __syncthreads_or) lists the tiles that have some; every
//   launch then visits only those, reading and writing nothing elsewhere.
//   The wrapper zeroes both ping-pong buffers once a call, so a skipped
//   tile's output is already there. (Checked in every launch instead, a
//   block pays a memory latency and a barrier for every empty tile: most of
//   a launch on a sparse mask.)
// * Persistent blocks. The grid is as many blocks as fit the SMs at once;
//   each walks the listed tiles i, i + grid, ...; the shared buffers keep
//   alternating across a block's tiles, so one barrier a pass is all.
//
// What bounds it on the H100: a launch reads 4 B of labels and 1 B of
// foreground and writes 4 B per voxel of a listed tile, and the halo tile
// re-reads SX SY SZ / (TX TY TZ) of it (2.6 here), mostly from L2. Inside a
// tile each voxel of the halo tile costs about 8 integer operations, 2
// shuffles / VZ and 3 shared-memory accesses a pass, and a tile is a chain
// of latencies (load, q barriers, store): the blocks an SM holds at once
// (MINB, by capping registers) overlap them. The defaults below (QMAX 2,
// 8 x 8 x 28 interior, three blocks an SM) were the fastest on the main
// path's sparse mask, and on the dense case too, of the candidates that
// skoots_tpu_torch/tools/bench_propagate.py builds from this file
// (-DPROP_QMAX=... -DPROP_TX=... -DPROP_TY=... -DPROP_VZ=... -DPROP_MINB=...):
// a larger QMAX re-reads and recomputes a halo that grows with it, which
// fewer launches do not repay. A 2.5D form (the tile's x planes streamed
// through a q-stage pipeline, a halo in y and z only) was 2-4x slower on
// both the sparse and the dense case: a barrier every plane, for only q
// stages' work between them.
#include "common.cuh"

#ifndef PROP_QMAX
#define PROP_QMAX 2
#endif
#ifndef PROP_TX
#define PROP_TX 8
#endif
#ifndef PROP_TY
#define PROP_TY 8
#endif
#ifndef PROP_VZ
#define PROP_VZ 1
#endif
#ifndef PROP_MINB
#define PROP_MINB 3
#endif

namespace {

constexpr int QMAX = PROP_QMAX;
constexpr int TX = PROP_TX;
constexpr int TY = PROP_TY;
constexpr int VZ = PROP_VZ;
constexpr int MIN_BLOCKS = PROP_MINB;  // blocks an SM must hold (registers)
constexpr int SX = TX + 2 * QMAX;
constexpr int SY = TY + 2 * QMAX;
constexpr int SZ = 32 * VZ;
constexpr int TZ = SZ - 2 * QMAX;
constexpr int THREADS = 32 * SY;
constexpr int PLANE = SY * SZ;  // one x plane of the halo tile in shared memory
constexpr int BUF = SX * PLANE;
constexpr int SMEM_BYTES = 2 * BUF * (int)sizeof(int32_t);
constexpr unsigned FULL = 0xffffffffu;
static_assert(QMAX >= 1 && SX <= 32, "a thread's foreground bits fill one word");
static_assert(TZ > 0 && THREADS <= 1024, "tile too large for one block");
static_assert(SMEM_BYTES <= 232448, "two buffers above 227 KB of shared memory");
static_assert(VZ == 1 || VZ == 2 || VZ == 4, "VZ is 1, 2 or 4");

// a lane's VZ values at one shared-memory row, as one access (conflict-free)
__device__ __forceinline__ void st_row(int32_t* p, const int32_t (&v)[VZ]) {
  if constexpr (VZ == 1) {
    *p = v[0];
  } else if constexpr (VZ == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  } else {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ void ld_row(const int32_t* p, int32_t (&v)[VZ]) {
  if constexpr (VZ == 1) {
    v[0] = *p;
  } else if constexpr (VZ == 2) {
    const int2 t = *reinterpret_cast<const int2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    const int4 t = *reinterpret_cast<const int4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
}

// The tiles whose interior holds foreground, once a call: a block a tile
// appends its index to tiles[] (*count zero on entry; the order varies
// between runs, the result does not: tiles are independent).
__global__ void __launch_bounds__(256)
tile_list_kernel(const uint8_t* __restrict__ fg, int X, int Y, int Z,
                 int* __restrict__ tiles, int* __restrict__ count) {
  const int nzt = (Z + TZ - 1) / TZ;
  const int nyt = (Y + TY - 1) / TY;
  const int tile = blockIdx.x;
  const int x0 = (tile / (nzt * nyt)) * TX;
  const int y0 = ((tile / nzt) % nyt) * TY;
  const int z0 = (tile % nzt) * TZ;
  const int ey = min(TY, Y - y0), ez = min(TZ, Z - z0);
  const int n = min(TX, X - x0) * ey * ez;
  bool any = false;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / ez;
    any |= fg[((long long)(x0 + r / ey) * Y + y0 + r % ey) * Z + z0 + i % ez] != 0;
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) tiles[atomicAdd(count, 1)] = tile;
}

template <bool CONN26>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
propagate_kernel(const int32_t* __restrict__ in, const uint8_t* __restrict__ fg,
                 int32_t* __restrict__ out, const int* __restrict__ tiles,
                 const int* __restrict__ count, int X, int Y, int Z, int q) {
  extern __shared__ __align__(16) int32_t smem[];  // [2][SX][SY][SZ]
  const int lane = threadIdx.x & 31;
  const int wy = threadIdx.x >> 5;  // halo row
  const bool own_y = wy >= QMAX && wy < QMAX + TY;
  const int nzt = (Z + TZ - 1) / TZ;
  const int nyt = (Y + TY - 1) / TY;
  const long long plane = (long long)Y * Z;
  const int n = *count;
  int pass = 0;  // this block's passes so far: the buffer parity
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const int tile = tiles[i];
    // halo origin x0; this warp's row gy; this lane's first z, gz0
    const int x0 = (tile / (nzt * nyt)) * TX - QMAX;
    const int gy = ((tile / nzt) % nyt) * TY - QMAX + wy;
    const int gz0 = (tile % nzt) * TZ - QMAX + lane * VZ;
    const bool yin = gy >= 0 && gy < Y;
    bool zin[VZ], zout[VZ];  // inside the volume; written (interior)
#pragma unroll
    for (int j = 0; j < VZ; ++j) {
      const int zl = lane * VZ + j;
      zin[j] = gz0 + j >= 0 && gz0 + j < Z;
      zout[j] = own_y && yin && zin[j] && zl >= QMAX && zl < QMAX + TZ;
    }
    // offset of (x0, gy, gz0); advanced a plane at a time
    const long long row0 = ((long long)x0 * Y + gy) * Z + gz0;

    // 1. the halo tile into registers, zero outside the volume
    int32_t s[SX][VZ];
    uint32_t f[VZ];
#pragma unroll
    for (int j = 0; j < VZ; ++j) f[j] = 0;
#pragma unroll
    for (int x = 0; x < SX; ++x) {
      const bool xin = yin && x0 + x >= 0 && x0 + x < X;
      const long long row = row0 + x * plane;
#pragma unroll
      for (int j = 0; j < VZ; ++j) {
        s[x][j] = 0;
        if (xin && zin[j]) {
          s[x][j] = __ldg(in + row + j);
          if (__ldg(fg + row + j)) f[j] |= 1u << x;
        }
      }
    }

    // 2. q passes
    for (int p = 0; p < q; ++p, ++pass) {
      int32_t* buf = smem + (pass & 1) * BUF;
      int32_t* mine = buf + wy * SZ + lane * VZ;
      if (!CONN26) {
#pragma unroll
        for (int x = 0; x < SX; ++x) st_row(mine + x * PLANE, s[x]);
      }
      int32_t prev[VZ];  // the pass input at plane x - 1
#pragma unroll
      for (int j = 0; j < VZ; ++j) prev[j] = s[0][j];
#pragma unroll
      for (int x = 0; x < SX; ++x) {
        int32_t t[VZ];
        if (CONN26) {
          // x then z: max over the 3 x 1 x 3 box
#pragma unroll
          for (int j = 0; j < VZ; ++j) {
            t[j] = max(prev[j], s[x][j]);
            if (x + 1 < SX) t[j] = max(t[j], s[x + 1][j]);
            prev[j] = s[x][j];
          }
          const int32_t lo = __shfl_up_sync(FULL, t[VZ - 1], 1);
          const int32_t hi = __shfl_down_sync(FULL, t[0], 1);
          int32_t u[VZ];
#pragma unroll
          for (int j = 0; j < VZ; ++j)
            u[j] = max(t[j], max(j > 0 ? t[j - 1] : lo, j + 1 < VZ ? t[j + 1] : hi));
#pragma unroll
          for (int j = 0; j < VZ; ++j) s[x][j] = u[j];
          st_row(mine + x * PLANE, s[x]);
        } else {
          // self, the two x faces and the two z faces of the pass input
          const int32_t lo = __shfl_up_sync(FULL, s[x][VZ - 1], 1);
          const int32_t hi = __shfl_down_sync(FULL, s[x][0], 1);
#pragma unroll
          for (int j = 0; j < VZ; ++j) {
            t[j] = max(prev[j], s[x][j]);
            if (x + 1 < SX) t[j] = max(t[j], s[x + 1][j]);
            t[j] = max(t[j], max(j > 0 ? s[x][j - 1] : lo, j + 1 < VZ ? s[x][j + 1] : hi));
          }
#pragma unroll
          for (int j = 0; j < VZ; ++j) {
            prev[j] = s[x][j];
            s[x][j] = t[j];
          }
        }
      }
      __syncthreads();
      // y: the rows above and below (a face row takes its own), then the mask
      const int32_t* up = buf + (wy > 0 ? wy - 1 : wy) * SZ + lane * VZ;
      const int32_t* dn = buf + (wy + 1 < SY ? wy + 1 : wy) * SZ + lane * VZ;
#pragma unroll
      for (int x = 0; x < SX; ++x) {
        int32_t a[VZ], b[VZ];
        ld_row(up + x * PLANE, a);
        ld_row(dn + x * PLANE, b);
#pragma unroll
        for (int j = 0; j < VZ; ++j)
          s[x][j] = (f[j] >> x) & 1u ? max(s[x][j], max(a[j], b[j])) : 0;
      }
    }

    // 3. the interior out
#pragma unroll
    for (int x = QMAX; x < QMAX + TX; ++x) {
      if (x0 + x < X) {
        const long long row = row0 + x * plane;
#pragma unroll
        for (int j = 0; j < VZ; ++j)
          if (zout[j]) out[row + j] = s[x][j];
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;

// Blocks of one instantiation resident at once on the current device (its
// persistent grid), after lifting its shared-memory limit; 0 on error.
template <bool CONN26>
int resident_blocks(cudaError_t* err) {
  static int cached[MAX_DEVICES] = {0};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev >= MAX_DEVICES) {
    *err = cudaErrorInvalidDevice;
    return 0;
  }
  if (!cached[dev]) {
    int per_sm = 0, sms = 0;
    *err = cudaFuncSetAttribute(propagate_kernel<CONN26>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (*err == cudaSuccess)
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, propagate_kernel<CONN26>,
                                                           THREADS, SMEM_BYTES);
    if (*err == cudaSuccess)
      *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err != cudaSuccess) return 0;
    cached[dev] = (per_sm > 0 ? per_sm : 1) * sms;
  }
  return cached[dev];
}

long long tile_count(int X, int Y, int Z) {
  return (long long)((X + TX - 1) / TX) * ((Y + TY - 1) / TY) * ((Z + TZ - 1) / TZ);
}

template <bool CONN26>
int launch(const int32_t* in, const uint8_t* fg, int32_t* out, const int* tiles,
           const int* count, int X, int Y, int Z, int q, cudaStream_t stream) {
  cudaError_t err;
  const int resident = resident_blocks<CONN26>(&err);
  if (!resident) return (int)err;
  const long long ntiles = tile_count(X, Y, Z);
  if (ntiles == 0) return 0;
  const int grid = ntiles < resident ? (int)ntiles : resident;
  propagate_kernel<CONN26><<<grid, THREADS, SMEM_BYTES, stream>>>(in, fg, out, tiles, count,
                                                                  X, Y, Z, q);
  return (int)cudaGetLastError();
}

}  // namespace

// Passes one launch may run (the halo depth), for the wrapper's launch plan.
extern "C" int skoots_propagate_qmax() { return QMAX; }

// Tiles of an X x Y x Z volume: the length of the tile list (-1 if above
// int range).
extern "C" int skoots_propagate_tile_count(int X, int Y, int Z) {
  const long long n = tile_count(X, Y, Z);
  return n > 0x7fffffffLL ? -1 : (int)n;
}

// The call's tile list from fg (uint8 [X, Y, Z]): tiles int32 [tile count],
// count int32 [1], zero on entry.
extern "C" int skoots_propagate_tiles(const void* fg, void* tiles, void* count, int X, int Y,
                                      int Z, void* stream) {
  const long long ntiles = tile_count(X, Y, Z);
  if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (ntiles == 0) return 0;
  tile_list_kernel<<<(unsigned)ntiles, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(fg), X, Y, Z, static_cast<int*>(tiles),
      static_cast<int*>(count));
  return (int)cudaGetLastError();
}

// labels_in, labels_out: int32 [X, Y, Z]; fg: uint8 [X, Y, Z] (0 or not);
// tiles, count: the call's tile list (skoots_propagate_tiles); 1 <= q <= QMAX
// passes. labels_out must hold zeros outside the listed tiles (the wrapper
// zeroes it once a call).
extern "C" int skoots_propagate(const void* labels_in, const void* fg, void* labels_out,
                                const void* tiles, const void* count, int X, int Y, int Z,
                                int q, int connectivity, void* stream) {
  if (q < 1 || q > QMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* in = static_cast<const int32_t*>(labels_in);
  const uint8_t* f = static_cast<const uint8_t*>(fg);
  int32_t* o = static_cast<int32_t*>(labels_out);
  const int* t = static_cast<const int*>(tiles);
  const int* c = static_cast<const int*>(count);
  if (connectivity == 26) return launch<true>(in, f, o, t, c, X, Y, Z, q, s);
  if (connectivity == 6) return launch<false>(in, f, o, t, c, X, Y, Z, q, s);
  return (int)cudaErrorInvalidValue;
}
