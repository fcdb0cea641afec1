// Weight gradient of the depthwise k^3 SAME correlation, channels-last:
//   dw[dx, dy, dz, c] = sum_{b, p} xpad[b, p + (dx, dy, dz), c] * g[b, p, c]
// with xpad the input zero-padded by (k - 1) / 2 on every side; f32 sums,
// summed over the batch.
//
// Replaces skoots_tpu/kernels/dwconv.py::dwconv3d_wgrad_pallas_v2 (the TPU
// default) and dwconv3d_wgrad_pallas (same function, full-block reduce).
//
// What bounds it on the H100: V voxels reduce into k^3 * C outputs with
// k^3 = 343 products per (voxel, channel). At bf16 every product of two
// bf16 values is exact in f32, so the tensor cores (f32 sums) do them, and
// then the bytes bind: at the training crop's C = 32 level (96 x 96 x 32)
// 37.8 MB of x and g, 0.011 ms at 3.35 TB/s. The TPU kernel carries its
// sums across its sequential grid in VMEM; here blocks run in parallel, so
// every block writes one row of partial sums, and a second launch adds the
// rows in a fixed order (no float atomics: the result is the same from run
// to run).
//
// bf16 with 16-byte channel groups (`dwconv3d_wgrad_tc_kernel`): the
// transpose of the forward's banded product (csrc/dwconv.cu). For one
// channel and one (dx, dy), with A[y][i] the input window of a staged x
// plane (16 window z from z0 - k/2, rows y0 - k/2 + dy + y) and G[y][j]
// the cotangent (rows y0 + y, 8 output z from z0),
//   E[i][j] = sum over x planes and 16 y rows of A[y][i] * G[y][j],
// one mma.sync m16n8k16 a plane (M = 16 window z, N = 8 z, K = 16 y rows),
// and dw[dx, dy, dz] = sum_j E[j + dz][j], the dz-th diagonal of E. Input
// planes are staged as the forward stages them (channel-major, z
// contiguous, cp.async ring, each thread transposing its own 16-byte
// items), the cotangent plane the same way without a halo; ldmatrix.trans
// loads A^T and G. A warp owns one channel and all k^2 (dx, dy) sums (k = 7:
// 196 registers): input plane xi pairs with the cotangent planes
// xi + k/2 - dx, whose G fragments it keeps in a ring of k registers pairs
// (the plane loop is unrolled by k, so the slots are compile-time). A block
// of 8 warps = 8 channels walks units (batch, x range, 16 y, 8 z) of its
// channel group, the launcher choosing the x range so that the units of a
// few waves of blocks balance; each block reduces its diagonals once, at
// the end, into its one partial row.
// tests/test_torch_wgrad_banded.py states this indexing in torch.
//
// The stem (1 -> 32, bf16; `stem_wgrad_tc_kernel`): an implicit GEMM, for
// each (dx, dy) and each (x, y) column E[dz][c] = sum_z
// xpad[x + dx, y + dy, z + dz] * g[x, y, z, c], with M = dz (rows 0-7 for
// dy, 8-15 for dy + 1: two dy a product, k of each 8 rows used), N = the
// 32 channels, K = 16 z; the A operand is a Hankel window of one input
// column, read as aligned bf16 pairs from a halo staged twice (the second
// copy shifted by one element), as the stem's forward does. A warp owns one
// dx, the block one (x, 16 y, 16 z) tile at a time of a persistent grid.
//
// f32, and bf16 without 16-byte channel groups (`dwconv3d_wgrad_kernel`):
// FP32 FMAs. The tensor cores would round f32 operands to TF32, which is
// not the function:
//  * a block stages an (TX+k-1) x (TY+k-1) x (TZ+k-1) x halo tile and the
//    matching TX x TY x TZ cotangent tile of CC channels in shared memory;
//  * each thread owns one (dx, dy, channel) and the k dz taps of it in
//    registers; per tile column (x, y) it loads the TZ+k-1 inputs and TZ
//    cotangents of its column once and reuses each for k taps;
//  * each block writes its k^3 x CC partial sums to its own row;
//  * the batch is a grid axis (its blocks are more rows), and the stem's
//    single input channel is read with a channel stride of 0, as in the
//    forward kernel (csrc/dwconv.cu).
#include "common.cuh"

#include <string.h>

namespace {

// ---- f32, and bf16 without 16-byte channel groups: FP32 FMAs ----------------


constexpr int CC = 8;   // channels per block
constexpr int TX = 8;   // voxel tile
constexpr int TY = 8;
constexpr int TZ = 16;

template <int K>
constexpr int smem_bytes(int elem) {
  return ((TX + K - 1) * (TY + K - 1) * (TZ + K - 1) + TX * TY * TZ) * CC * elem;
}

int n_tiles(int B, int X, int Y, int Z) {
  return B * ((X + TX - 1) / TX) * ((Y + TY - 1) / TY) * ((Z + TZ - 1) / TZ);
}

template <typename T, int K>
__global__ void __launch_bounds__(K * K * CC)
dwconv3d_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      float* __restrict__ partial, int X, int Y, int Z, int C,
                      long long x_vstride, long long x_cstride) {
  constexpr int P = (K - 1) / 2;
  constexpr int SX = TX + K - 1, SY = TY + K - 1, SZ = TZ + K - 1;
  constexpr int NT = K * K * CC;  // one thread per (dx, dy, channel)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [SX][SY][SZ][CC]
  T* gs = xs + SX * SY * SZ * CC;          // [TX][TY][TZ][CC]

  const int nzb = (Z + TZ - 1) / TZ;
  const int nyb = (Y + TY - 1) / TY;
  const int nxb = (X + TX - 1) / TX;
  const int z0 = (blockIdx.x % nzb) * TZ;
  const int y0 = (blockIdx.x / nzb) * TY;
  const int x0 = blockIdx.y * TX;
  const int nchunk = (C + CC - 1) / CC;
  const int bi = blockIdx.z / nchunk;
  const int c0 = (blockIdx.z % nchunk) * CC;
  const int tid = threadIdx.x;

  const T* xb = x + (long long)bi * X * Y * Z * x_vstride;
  for (int i = tid; i < SX * SY * SZ * CC; i += NT) {
    const int cc = i % CC;
    int r = i / CC;
    const int sz = r % SZ;
    r /= SZ;
    const int sy = r % SY;
    const int sx = r / SY;
    const int gx = x0 + sx - P, gy = y0 + sy - P, gz = z0 + sz - P;
    const int c = c0 + cc;
    T v = from_f32<T>(0.f);
    if (gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z && c < C)
      v = xb[(((long long)gx * Y + gy) * Z + gz) * x_vstride + c * x_cstride];
    xs[i] = v;
  }
  const T* gb = g + (long long)bi * X * Y * Z * C;
  for (int i = tid; i < TX * TY * TZ * CC; i += NT) {
    const int cc = i % CC;
    int r = i / CC;
    const int tz = r % TZ;
    r /= TZ;
    const int ty = r % TY;
    const int tx = r / TY;
    const int gx = x0 + tx, gy = y0 + ty, gz = z0 + tz;
    const int c = c0 + cc;
    T v = from_f32<T>(0.f);  // cotangent 0 outside the volume: no contribution
    if (gx < X && gy < Y && gz < Z && c < C)
      v = gb[(((long long)gx * Y + gy) * Z + gz) * C + c];
    gs[i] = v;
  }
  __syncthreads();

  const int cc = tid % CC;
  const int dy = (tid / CC) % K;
  const int dx = tid / (CC * K);
  float acc[K];
#pragma unroll
  for (int d = 0; d < K; ++d) acc[d] = 0.f;

  for (int tx = 0; tx < TX; ++tx) {
#pragma unroll 1
    for (int ty = 0; ty < TY; ++ty) {
      const T* col = xs + ((tx + dx) * SY + (ty + dy)) * SZ * CC + cc;
      const T* gcol = gs + (tx * TY + ty) * TZ * CC + cc;
      float v[SZ];
#pragma unroll
      for (int s = 0; s < SZ; ++s) v[s] = to_f32<T>(col[s * CC]);
#pragma unroll
      for (int z = 0; z < TZ; ++z) {
        const float gv = to_f32<T>(gcol[z * CC]);
#pragma unroll
        for (int dz = 0; dz < K; ++dz) acc[dz] = fmaf(v[z + dz], gv, acc[dz]);
      }
    }
  }

  const int c = c0 + cc;
  if (c >= C) return;
  const long long blk =
      ((long long)bi * nxb + blockIdx.y) * ((long long)nyb * nzb) + blockIdx.x;
  float* out = partial + blk * (K * K * K) * C + c;
#pragma unroll
  for (int dz = 0; dz < K; ++dz)
    out[(long long)((dx * K + dy) * K + dz) * C] = acc[dz];
}

// ---- the fixed-order sum over rows ------------------------------------------

constexpr int RED_ROWS = 8;   // row groups of a reduce block
constexpr int RED_COLS = 32;  // outputs of a reduce block

// out[i] = sum over the rows r of partial[r, i]: thread (rg, o) adds rows
// rg, rg + 8, ... in order, then the 8 sums add in the order rg = 0, 1, ...
// The order depends only on the row count: the same every run.
__global__ void __launch_bounds__(RED_ROWS * RED_COLS)
wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int rows,
                    int n) {
  __shared__ float part[RED_ROWS][RED_COLS];
  const int o = threadIdx.x % RED_COLS, rg = threadIdx.x / RED_COLS;
  const int i = blockIdx.x * RED_COLS + o;
  float s = 0.f;
  if (i < n)
    for (int r = rg; r < rows; r += RED_ROWS) s += partial[(long long)r * n + i];
  part[rg][o] = s;
  __syncthreads();
  if (rg == 0 && i < n) {
    float t = part[0][o];
#pragma unroll
    for (int j = 1; j < RED_ROWS; ++j) t += part[j][o];
    out[i] = t;
  }
}

// ---- bf16 depthwise on the tensor cores ---------------------------------------

using bf16 = __nv_bfloat16;

constexpr int WT_WARPS = 8;  // = the channels of a block
constexpr int WT_THREADS = WT_WARPS * 32;
constexpr int WT_YT = 16;  // cotangent rows of a unit: the mma's K
constexpr int WT_ZT = 8;   // cotangent z of a unit: the mma's N
constexpr int WT_ZW = 16;  // input z window: the mma's M
constexpr int WT_ZP = 24;  // padded window row: 48 bytes, so the 8 rows of
                           // an ldmatrix fall in distinct banks
constexpr int WT_AHEAD = 3;  // planes in flight ahead of the one computed
constexpr int WT_DEPTH = WT_AHEAD + 1;

template <int K>
struct WgTc {
  static constexpr int P = K / 2;
  static constexpr int YS = WT_YT + K - 1;       // staged input rows
  static constexpr int PLANE = YS * WT_ZP;       // one channel's staged input plane
  static constexpr int BUF = WT_WARPS * PLANE;   // one staged input x plane
  static constexpr int GPLANE = WT_YT * WT_ZT;   // one channel's cotangent plane
  static constexpr int GBUF = WT_WARPS * GPLANE;
  static constexpr int ITEMS = (YS * WT_ZW + WT_THREADS - 1) / WT_THREADS;
  static constexpr int RAW_ROWS = ITEMS + 1;     // + one cotangent item (threads < 128)
  static constexpr int SMEM = (2 * BUF + 2 * GBUF) * 2 +
                              WT_DEPTH * RAW_ROWS * WT_THREADS * 16 +
                              WT_WARPS * WT_ZW * WT_ZT * 4;
};

template <int K>
__global__ void __launch_bounds__(WT_THREADS, 1)
dwconv3d_wgrad_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                         float* __restrict__ partial, int X, int Y, int Z, int C, int nxs,
                         int xt, int units, int nper) {
  using W = WgTc<K>;
  constexpr int P = W::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);  // [2][8 ch][YS][ZP]
  bf16* gbuf = buf + 2 * W::BUF;                  // [2][8 ch][YT][ZT]
  uint4* raw0 = reinterpret_cast<uint4*>(gbuf + 2 * W::GBUF);  // [DEPTH][RAW_ROWS][THREADS]
  float* diag = reinterpret_cast<float*>(raw0 + WT_DEPTH * W::RAW_ROWS * WT_THREADS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ncg = C / WT_WARPS;
  const int cg = blockIdx.x % ncg, slot = blockIdx.x / ncg;
  const int c0 = cg * WT_WARPS;
  const int nzb = (Z + WT_ZT - 1) / WT_ZT, nyb = (Y + WT_YT - 1) / WT_YT;
  const long long plane = (long long)Y * Z * C;
  // ldmatrix.trans lanes: A^T's four 8x8 matrices are (window z 0-7 | 8-15)
  // x (y 0-7 | 8-15), lane l giving row (l & 7) + 8 (l >> 4) at column
  // 8 ((l >> 3) & 1); G's two are y 0-7 and 8-15
  const int a_off = warp * W::PLANE + ((lane & 7) + ((lane >> 4) << 3)) * WT_ZP +
                    ((lane >> 3) & 1) * 8;
  const int g_off = warp * W::GPLANE + (lane & 15) * WT_ZT;

  // acc[dx * K + dy]: E of (dx, dy) over every unit of the block
  float acc[K * K][4];
#pragma unroll
  for (int t = 0; t < K * K; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  for (int u = slot; u < units; u += nper) {
    int r = u;
    const int zb = r % nzb;
    r /= nzb;
    const int yb = r % nyb;
    r /= nyb;
    const int xsp = r % nxs, bi = r / nxs;
    const int z0 = zb * WT_ZT, y0 = yb * WT_YT;
    const int xs = xsp * xt;
    const int ng = min(X, xs + xt) - xs;  // cotangent planes xs ... xs + ng - 1
    const int nsteps = ng + K - 1;        // input planes xs - P ... xs + ng - 1 + P
    // the thread's input items: window row i / 16 (y0 - P + row) and column
    // i % 16 (z0 - P + column), 8 channels of one voxel; -1 outside the
    // volume (staged as zeros) or past the window
    int off[W::ITEMS], dst[W::ITEMS];
#pragma unroll
    for (int j = 0; j < W::ITEMS; ++j) {
      const int i = tid + j * WT_THREADS;
      const int gy = y0 - P + i / WT_ZW, gz = z0 - P + i % WT_ZW;
      const bool in = i < W::YS * WT_ZW;
      off[j] = in && gy >= 0 && gy < Y && gz >= 0 && gz < Z ? (gy * Z + gz) * C + c0 : -1;
      dst[j] = in ? (i / WT_ZW) * WT_ZP + i % WT_ZW : -1;
    }
    // the thread's cotangent item (threads < 128): row tid / 8, z tid % 8
    const int gy = y0 + tid / WT_ZT, gz = z0 + tid % WT_ZT;
    const int goff = tid < WT_YT * WT_ZT && gy < Y && gz < Z ? (gy * Z + gz) * C + c0 : -1;
    const bf16* xb = x + (long long)bi * X * plane;
    const bf16* gb = g + (long long)bi * X * plane;

    // step t: input plane xs - P + t and cotangent plane xs + t into ring
    // slot t % DEPTH; one commit group a step
    auto fetch = [&](int t) {
      uint4* raw = raw0 + (t % WT_DEPTH) * W::RAW_ROWS * WT_THREADS + tid;
      const int xi = xs - P + t;
      if (t < nsteps && xi >= 0 && xi < X) {
        const bf16* src = xb + xi * plane;
#pragma unroll
        for (int j = 0; j < W::ITEMS; ++j)
          if (off[j] >= 0) cp_async16(raw + j * WT_THREADS, src + off[j], 16);
      }
      if (t < ng && goff >= 0)
        cp_async16(raw + W::ITEMS * WT_THREADS, gb + (xs + t) * plane + goff, 16);
      cp_async_commit();
    };
    // step t's planes, landed, into the channel planes of buffer t & 1
    auto stage = [&](int t) {
      const uint4* raw = raw0 + (t % WT_DEPTH) * W::RAW_ROWS * WT_THREADS + tid;
      const int xi = xs - P + t;
      const bool in = xi >= 0 && xi < X;
      unsigned short* d0 = reinterpret_cast<unsigned short*>(buf + (t & 1) * W::BUF);
#pragma unroll
      for (int j = 0; j < W::ITEMS; ++j) {
        if (dst[j] < 0) continue;
        const uint4 v = in && off[j] >= 0 ? raw[j * WT_THREADS] : make_uint4(0, 0, 0, 0);
        const unsigned short* h = reinterpret_cast<const unsigned short*>(&v);
#pragma unroll
        for (int ch = 0; ch < WT_WARPS; ++ch) d0[ch * W::PLANE + dst[j]] = h[ch];
      }
      if (tid < WT_YT * WT_ZT) {
        const uint4 v = t < ng && goff >= 0 ? raw[W::ITEMS * WT_THREADS] : make_uint4(0, 0, 0, 0);
        const unsigned short* h = reinterpret_cast<const unsigned short*>(&v);
        unsigned short* gd = reinterpret_cast<unsigned short*>(gbuf + (t & 1) * W::GBUF) + tid;
#pragma unroll
        for (int ch = 0; ch < WT_WARPS; ++ch) gd[ch * W::GPLANE] = h[ch];
      }
    };

    // gfr[s]: the G fragments of cotangent plane xs + t with t % K == s;
    // step t pairs input plane xs - P + t with cotangent plane xs + t - dx
    uint32_t gfr[K][2];
#pragma unroll
    for (int s = 0; s < K; ++s) gfr[s][0] = gfr[s][1] = 0u;
#pragma unroll
    for (int t = 0; t < WT_AHEAD; ++t) fetch(t);
    cp_async_wait_group<WT_AHEAD - 1>();
    stage(0);
    __syncthreads();
    // unrolled by K, so the ring slots are compile-time register indices
    for (int t0 = 0; t0 < nsteps; t0 += K) {
#pragma unroll
      for (int rr = 0; rr < K; ++rr) {
        const int t = t0 + rr;
        if (t >= nsteps) break;
        fetch(t + WT_AHEAD);
        const int xi = xs - P + t;
        if (t < ng) ldmatrix_x2_trans(gfr[rr], gbuf + (t & 1) * W::GBUF + g_off);
        if (xi >= 0 && xi < X) {
          const bf16* pl = buf + (t & 1) * W::BUF + a_off;
#pragma unroll
          for (int dy = 0; dy < K; ++dy) {
            uint32_t a[4];
            ldmatrix_x4_trans(a, pl + dy * WT_ZP);
#pragma unroll
            for (int dx = 0; dx < K; ++dx) {
              const int tg = t - dx;  // cotangent plane xs + tg
              if (tg >= 0 && tg < ng)
                mma_bf16_16816(acc[dx * K + dy], a, gfr[(rr - dx + K) % K][0],
                               gfr[(rr - dx + K) % K][1]);
            }
          }
        }
        cp_async_wait_group<WT_AHEAD - 1>();  // this thread's copies of step t + 1
        stage(t + 1);
        // one barrier a step: step t + 1 is staged, and every warp is done
        // with the buffers of step t - 1, which this step's stage overwrote
        __syncthreads();
      }
    }
  }

  // dw[dx, dy, dz, c] = sum_j E[j + dz][j]: the fragment through shared
  // memory, lane dz adding its diagonal in the order j = 0, 1, ...
  const int gq = lane >> 2, q = lane & 3;
  float* dg = diag + warp * WT_ZW * WT_ZT;
  float* row = partial + (long long)slot * (K * K * K) * C + c0 + warp;
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    dg[gq * WT_ZT + 2 * q] = acc[t][0];
    dg[gq * WT_ZT + 2 * q + 1] = acc[t][1];
    dg[(gq + 8) * WT_ZT + 2 * q] = acc[t][2];
    dg[(gq + 8) * WT_ZT + 2 * q + 1] = acc[t][3];
    __syncwarp();
    if (lane < K) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < WT_ZT; ++j) s += dg[(j + lane) * WT_ZT + j];
      row[(long long)(t * K + lane) * C] = s;
    }
    __syncwarp();
  }
}

// ---- the bf16 stem (1 -> 32) as an implicit GEMM on the tensor cores ----------

constexpr int SW_C = 32;         // output channels (the mma's N: 4 tiles of 8)
constexpr int SW_ZT = 16;        // cotangent z of a column: the mma's K
constexpr int SW_YT = 16;        // columns (y) of a tile
constexpr int SW_NS = SW_C + 8;  // padded cotangent row (80 bytes)

template <int K>
struct StemW {
  static constexpr int P = K / 2;
  static constexpr int PAIRS = (K + 1) / 2;    // dy pairs (2p, 2p + 1)
  static constexpr int THREADS = K * 32;       // a warp a dx
  static constexpr int HY = SW_YT + K - 1;     // halo rows
  static constexpr int HZ = SW_ZT + 8;         // halo row: 16 + k - 1 z, + 1 shift
  static constexpr int HALO = K * HY * HZ;     // one copy (elements)
  static constexpr int SMEM = (SW_YT * SW_ZT * SW_NS + 2 * HALO) * 2;
};

template <int K>
__global__ void __launch_bounds__(K * 32)
stem_wgrad_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     float* __restrict__ partial, int B, int X, int Y, int Z) {
  using S = StemW<K>;
  constexpr int P = S::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* gs = reinterpret_cast<bf16*>(smem_raw);  // [YT][ZT][NS]
  bf16* halo = gs + SW_YT * SW_ZT * SW_NS;        // [2][K][HY][HZ]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;  // warp = dx
  const int gq = lane >> 2, q = lane & 3;
  // the halo's columns past 16 + k - 1 z (read only by rows dz >= k, whose
  // sums are dropped) stay zero, never garbage
  for (int i = tid; i < 2 * S::HALO; i += S::THREADS) halo[i] = __float2bfloat16_rn(0.f);
  // the lane's pair of z (2q, 2q + 1) + dz (= gq) starts at halo z gq + 2q:
  // even in copy 0, odd ones aligned in copy 1 (shifted by one)
  const bf16* hsrc = halo + (gq & 1) * S::HALO + (gq & 1) + warp * S::HY * S::HZ + gq + 2 * q;
  const int kr = (lane & 7) + ((lane >> 3) & 1) * 8, nc = (lane >> 4) * 8;

  // acc[p][n]: rows dz of dy = 2p (0-7) and dy = 2p + 1 (8-15), channels
  // n * 8 ... n * 8 + 7
  float acc[S::PAIRS][4][4];
#pragma unroll
  for (int p = 0; p < S::PAIRS; ++p)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][n][e] = 0.f;

  const int nzt = (Z + SW_ZT - 1) / SW_ZT, nyt = (Y + SW_YT - 1) / SW_YT;
  const long long ntiles = (long long)B * X * nyt * nzt;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    long long r = tile;
    const int zt = (int)(r % nzt);
    r /= nzt;
    const int yt = (int)(r % nyt);
    r /= nyt;
    const int xo = (int)(r % X);
    const int bi = (int)(r / X);
    const int z0 = zt * SW_ZT, y0 = yt * SW_YT;
    __syncthreads();  // every warp is done with the last tile
    // the cotangent tile, 16-byte pieces of 8 channels, zero outside
    for (int i = tid; i < SW_YT * SW_ZT * 4; i += S::THREADS) {
      const int piece = i % 4, zz = (i / 4) % SW_ZT, yy = i / (4 * SW_ZT);
      const int gy = y0 + yy, gz = z0 + zz;
      const bool ok = gy < Y && gz < Z;
      const bf16* src =
          ok ? g + ((((long long)bi * X + xo) * Y + gy) * Z + gz) * SW_C + piece * 8 : g;
      cp_async16(gs + (yy * SW_ZT + zz) * SW_NS + piece * 8, src, ok ? 16 : 0);
    }
    cp_async_commit();
    for (int i = tid; i < K * S::HY * (SW_ZT + K - 1); i += S::THREADS) {
      const int hz = i % (SW_ZT + K - 1);
      const int rest = i / (SW_ZT + K - 1);
      const int hy = rest % S::HY, hx = rest / S::HY;
      const int gx = xo - P + hx, gy = y0 - P + hy, gz = z0 - P + hz;
      bf16 v = __float2bfloat16_rn(0.f);
      if (gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z)
        v = x[(((long long)bi * X + gx) * Y + gy) * Z + gz];
      const int o = (hx * S::HY + hy) * S::HZ + hz;
      halo[o] = v;
      halo[S::HALO + o + 1] = v;
    }
    cp_async_wait_all();
    __syncthreads();
    const int ny = min(SW_YT, Y - y0);
    for (int yy = 0; yy < ny; ++yy) {
      uint32_t bb[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
        ldmatrix_x4_trans(bb[nb], gs + (yy * SW_ZT + kr) * SW_NS + nb * 16 + nc);
#pragma unroll
      for (int p = 0; p < S::PAIRS; ++p) {
        const bf16* r0 = hsrc + (yy + 2 * p) * S::HZ;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(r0);
        a[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        if (2 * p + 1 < K) {
          a[1] = *reinterpret_cast<const uint32_t*>(r0 + S::HZ);
          a[3] = *reinterpret_cast<const uint32_t*>(r0 + S::HZ + 8);
        } else {
          a[1] = a[3] = 0u;
        }
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          mma_bf16_16816(acc[p][2 * nb], a, bb[nb][0], bb[nb][1]);
          mma_bf16_16816(acc[p][2 * nb + 1], a, bb[nb][2], bb[nb][3]);
        }
      }
    }
  }

  // the block's row: tap (dx, dy, dz = gq), channels n * 8 + 2q, + 1
  if (gq >= K) return;
  float* row = partial + (long long)blockIdx.x * (K * K * K) * SW_C;
#pragma unroll
  for (int p = 0; p < S::PAIRS; ++p)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int dy = 2 * p + h;
        if (dy >= K) continue;
        float* o = row + ((warp * K + dy) * K + gq) * SW_C + n * 8 + 2 * q;
        o[0] = acc[p][n][2 * h];
        o[1] = acc[p][n][2 * h + 1];
      }
}

// ---- launch plans ---------------------------------------------------------------

enum Path { FP32 = 0, DEPTHWISE_TC = 1, STEM_TC = 2 };

// what a call launches, from make_plan; the caller keeps it as int32
// [PLAN_INTS] (skoots_dwconv3d_wgrad_plan) and hands it to every launch at
// the same operands, so a call plans nothing
struct Plan {
  int path = FP32;
  int rows = 0;   // rows of the partial buffer (= blocks, or tiles of the FP32 kernel)
  int grid = 0;
  int nxs = 1, xt = 1, units = 0, nper = 0;  // the depthwise tensor-core kernel
  int smem = 0;
};
constexpr int PLAN_INTS = 8;
static_assert(sizeof(Plan) == PLAN_INTS * sizeof(int), "Plan is PLAN_INTS ints");

// The card's SM count and `kernel`'s resident blocks an SM at `smem`
// bytes, its shared-memory limit raised to them: asked once a device (one
// static cache a TAG, one TAG a kernel instantiation), so a call spends no
// host time on them.
template <int TAG, typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, int smem, int* sms, int* per_sm) {
  static int cached_dev = -1, cached_sms = 0, cached_per_sm = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != cached_dev) {
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess ||
        (e = cudaDeviceGetAttribute(&cached_sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached_per_sm, kernel, threads,
                                                           smem)) != cudaSuccess)
      return e;
    if (cached_per_sm < 1) return cudaErrorInvalidConfiguration;
    cached_dev = dev;
  }
  *sms = cached_sms;
  *per_sm = cached_per_sm;
  return cudaSuccess;
}

template <typename T, int K>
cudaError_t make_plan(const void* x, const void* g, int B, int X, int Y, int Z, int C,
                      long long x_vstride, long long x_cstride, Plan* plan) {
  Plan p;
  if ((long long)B * X * Y * Z * C == 0) {  // no products: only the reduce, of 0 rows
    *plan = p;
    return cudaSuccess;
  }
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const bool bf = sizeof(T) == 2;
  cudaError_t e = cudaSuccess;
  if (bf && reinterpret_cast<uintptr_t>(g) % 16 == 0 && x_cstride == 0 && x_vstride == 1 &&
      C == SW_C) {
    using S = StemW<K>;
    p.path = STEM_TC;
    p.smem = S::SMEM;
    int sms = 0, per_sm = 0;
    e = occupancy<STEM_TC * 16 + K>(stem_wgrad_tc_kernel<K>, S::THREADS, p.smem, &sms, &per_sm);
    if (e != cudaSuccess) return e;
    // a row of partial sums a block (43.9 KB at k = 7): two blocks an SM
    // at most
    const long long tiles = (long long)B * X * ((Y + SW_YT - 1) / SW_YT) *
                            ((Z + SW_ZT - 1) / SW_ZT);
    const long long cap = (long long)sms * (per_sm < 2 ? per_sm : 2);
    p.grid = p.rows = (int)(tiles < cap ? tiles : cap);
  } else if (bf && aligned && x_cstride == 1 && x_vstride == C && C % WT_WARPS == 0 &&
             (long long)Y * Z * C < (1LL << 31)) {
    using W = WgTc<K>;
    p.path = DEPTHWISE_TC;
    p.smem = W::SMEM;
    int sms = 0, per_sm = 0;
    e = occupancy<DEPTHWISE_TC * 16 + K>(dwconv3d_wgrad_tc_kernel<K>, WT_THREADS, p.smem, &sms,
                                         &per_sm);
    if (e != cudaSuccess) return e;
    // blocks a channel group: one wave of the card; then the x range whose
    // units, dealt round-robin to those blocks, finish soonest (a unit of
    // xt cotangent planes costs xt + k - 1 input planes and a short
    // prologue)
    const int ncg = C / WT_WARPS;
    const long long target_ll = (long long)sms * per_sm / ncg;
    const long long target = target_ll < 1 ? 1 : target_ll;
    const long long cols =
        (long long)B * ((Y + WT_YT - 1) / WT_YT) * ((Z + WT_ZT - 1) / WT_ZT);
    long long best = -1;
    for (int nxs = 1; nxs <= X; ++nxs) {
      const int xt = (X + nxs - 1) / nxs;
      if ((X + xt - 1) / xt != nxs) continue;
      const long long units = cols * nxs;
      if (units > 0x7fffffffLL) break;
      const long long per_block = (units + target - 1) / target;
      const long long cost = per_block * (xt + K - 1 + 2);
      if (best < 0 || cost < best) {
        best = cost;
        p.nxs = nxs;
        p.xt = xt;
        p.units = (int)units;
        p.nper = (int)((units + per_block - 1) / per_block);
      }
    }
    p.rows = p.nper;
    p.grid = ncg * p.nper;
  } else {
    p.path = FP32;
    p.smem = smem_bytes<K>(sizeof(T));
    if ((e = cudaFuncSetAttribute(dwconv3d_wgrad_kernel<T, K>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem)) !=
        cudaSuccess)
      return e;
    p.rows = n_tiles(B, X, Y, Z);
  }
  *plan = p;
  return cudaSuccess;
}

template <typename T, int K>
int launch(const void* x, const void* g, float* partial, float* out, int B, int X, int Y,
           int Z, int C, long long x_vstride, long long x_cstride, const Plan& p,
           cudaStream_t stream) {
  const int n = K * K * K * C;
  if (p.rows > 0) {
    if (p.path == STEM_TC) {
      stem_wgrad_tc_kernel<K><<<p.grid, StemW<K>::THREADS, p.smem, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(g), partial, B, X, Y, Z);
    } else if (p.path == DEPTHWISE_TC) {
      dwconv3d_wgrad_tc_kernel<K><<<p.grid, WT_THREADS, p.smem, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(g), partial, X, Y, Z, C, p.nxs,
          p.xt, p.units, p.nper);
    } else {
      dim3 grid(((Z + TZ - 1) / TZ) * ((Y + TY - 1) / TY), (X + TX - 1) / TX,
                B * ((C + CC - 1) / CC));
      dwconv3d_wgrad_kernel<T, K><<<grid, K * K * CC, p.smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(g), partial, X, Y, Z, C, x_vstride,
          x_cstride);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // rows = 0 (no products): dw = 0
  wgrad_reduce_kernel<<<(n + RED_COLS - 1) / RED_COLS, RED_ROWS * RED_COLS, 0, stream>>>(
      partial, out, p.rows, n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_launch(int k, const void* x, const void* g, float* partial, float* out, int B,
                    int X, int Y, int Z, int C, long long x_vstride, long long x_cstride,
                    const Plan& p, cudaStream_t s) {
  switch (k) {
    case 3: return launch<T, 3>(x, g, partial, out, B, X, Y, Z, C, x_vstride, x_cstride, p, s);
    case 5: return launch<T, 5>(x, g, partial, out, B, X, Y, Z, C, x_vstride, x_cstride, p, s);
    case 7: return launch<T, 7>(x, g, partial, out, B, X, Y, Z, C, x_vstride, x_cstride, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_plan(int k, const void* x, const void* g, int B, int X, int Y, int Z,
                          int C, long long x_vstride, long long x_cstride, Plan* p) {
  switch (k) {
    case 3: return make_plan<T, 3>(x, g, B, X, Y, Z, C, x_vstride, x_cstride, p);
    case 5: return make_plan<T, 5>(x, g, B, X, Y, Z, C, x_vstride, x_cstride, p);
    case 7: return make_plan<T, 7>(x, g, B, X, Y, Z, C, x_vstride, x_cstride, p);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch plan for these operands (the kernel, the partial-sum rows at
// plan[1], the grid), into int32 plan[PLAN_INTS]. It depends on the shape,
// dtype, k, strides, the 16-byte alignment of x and g and the card (its SM
// count), so a caller may keep it for further calls that agree in all of
// these. Returns a CUDA error code.
extern "C" int skoots_dwconv3d_wgrad_plan(int dtype, const void* x, const void* g, int B,
                                          int X, int Y, int Z, int C, int k,
                                          long long x_vstride, long long x_cstride,
                                          int* plan) {
  Plan p;
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == SKOOTS_BF16)
    e = dispatch_plan<__nv_bfloat16>(k, x, g, B, X, Y, Z, C, x_vstride, x_cstride, &p);
  else if (dtype == SKOOTS_F32)
    e = dispatch_plan<float>(k, x, g, B, X, Y, Z, C, x_vstride, x_cstride, &p);
  if (e == cudaSuccess) memcpy(plan, &p, sizeof(Plan));
  return (int)e;
}

// x: [B, X, Y, Z, *] of `dtype`, element (v, c) at v * x_vstride + c *
// x_cstride (x_cstride = 0: one input channel read for all C, the stem);
// g: [B, X, Y, Z, C] of `dtype`; plan: as skoots_dwconv3d_wgrad_plan gave
// it for these operands; partial: f32 scratch [plan[1], k^3, C]; out: f32
// [k, k, k, C].
extern "C" int skoots_dwconv3d_wgrad(int dtype, const void* x, const void* g, void* partial,
                                     void* out, int B, int X, int Y, int Z, int C, int k,
                                     long long x_vstride, long long x_cstride,
                                     const int* plan, void* stream) {
  Plan p;
  memcpy(&p, plan, sizeof(Plan));
  if (p.path < FP32 || p.path > STEM_TC || p.rows < 0) return (int)cudaErrorInvalidValue;
  float* pf = static_cast<float*>(partial);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == SKOOTS_BF16)
    return dispatch_launch<__nv_bfloat16>(k, x, g, pf, of, B, X, Y, Z, C, x_vstride,
                                          x_cstride, p, s);
  if (dtype == SKOOTS_F32)
    return dispatch_launch<float>(k, x, g, pf, of, B, X, Y, Z, C, x_vstride, x_cstride, p, s);
  return (int)cudaErrorInvalidValue;
}
