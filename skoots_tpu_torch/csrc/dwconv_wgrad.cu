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
// Every other bf16 stem with C % 8 == 0, 8 <= C <= 256 and odd k <= 15
// (`stem_wgrad_chunk_kernel`): the same products with N in chunks of at
// most 64 channels and 16 dz rows a dy at k >= 9, a warp holding a few
// (dx, dy) items (below; tests/test_torch_stem_gemm.py states it). `route`
// is the one choice of kernel, shared with `skoots_dwconv3d_wgrad_route`.
//
// bf16 depthwise layers with 16-byte channel groups at k = 9, 11, 13, 15
// (`dwconv3d_wgrad_big_kernel`): the transposed band in one or two bands,
// the (dx, dy) sums of a channel split into dy groups, below.
//
// Any other odd k (`dwconv3d_wgrad_any_kernel`: f32, bf16 without 16-byte
// channel groups, k > 15): a thread a weight-gradient entry of a partial
// row, below.
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

// ---- bf16 depthwise layers at k = 9, 11, 13, 15 on the tensor cores ---------
//
// `dwconv3d_wgrad_big_kernel<K>`: dwconv3d_wgrad_tc_kernel's transposed band
// (E = A^T G per (dx, dy) and plane, M = 16 window z, N = 8 z, K = 16 y rows;
// dw[dx, dy, dz] the dz-th diagonal of E) past k = 7, where:
//  * a 16-row window holds the diagonals dz <= 8 only (j + dz <= 15 for
//    j < 8), so k = 11 to 15 take two bands as the forward does: band 0
//    over the window z0 - P ... z0 - P + 15 gives dz 0-7, band 1 over the
//    window from z0 - P + 8 gives dz 8 ... k - 1 (its diagonal dz - 8);
//    both products share the cotangent fragment, and a staged row holds 24
//    window columns;
//  * a warp's k^2 x bands sums no longer fit its registers (k = 9: 324
//    f32), so the dy of a channel split into groups of DG (3 at k = 9, 1
//    above: the k dx x DG x bands x 4 f32 sums, at most 120), a grid axis;
//    a block streams only its group's DG + 15 input rows, and each A
//    fragment still feeds the k dx products (the cotangent planes' ring of
//    k fragment pairs, as in dwconv3d_wgrad_tc_kernel).
// Every (channel group, dy group) block of one slot walks the same units in
// the same order and writes its own taps of its channels to the slot's
// partial row, so each row is written whole and once, and
// wgrad_reduce_kernel adds the rows in its fixed order: the same result
// every run. tests/test_torch_dwconv_bigk.py states this indexing in torch.
template <int K>
struct WgBig {
  static constexpr int P = K / 2;
  static constexpr int NB = K <= 9 ? 1 : 2;       // bands
  static constexpr int DG = K == 9 ? 3 : 1;       // dy of a group
  static constexpr int NGR = K / DG;              // dy groups
  static constexpr int ZW = 8 + 8 * NB;           // staged window columns
  static constexpr int YS = WT_YT + DG - 1;       // staged input rows
  static constexpr int PLANE = YS * WT_ZP;
  static constexpr int BUF = WT_WARPS * PLANE;
  static constexpr int GPLANE = WT_YT * WT_ZT;
  static constexpr int GBUF = WT_WARPS * GPLANE;
  static constexpr int NITEM = YS * ZW;
  static constexpr int ITEMS = (NITEM + WT_THREADS - 1) / WT_THREADS;
  static constexpr int RAW_ROWS = ITEMS + 1;      // + one cotangent item (threads < 128)
  static constexpr int SMEM = (2 * BUF + 2 * GBUF) * 2 +
                              WT_DEPTH * RAW_ROWS * WT_THREADS * 16 +
                              WT_WARPS * WT_ZW * WT_ZT * 4;
};

template <int K>
__global__ void __launch_bounds__(WT_THREADS, 1)
dwconv3d_wgrad_big_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                          float* __restrict__ partial, int X, int Y, int Z, int C, int nxs,
                          int xt, int units, int nper) {
  using W = WgBig<K>;
  constexpr int P = W::P, NB = W::NB, DG = W::DG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);  // [2][8 ch][YS][ZP]
  bf16* gbuf = buf + 2 * W::BUF;                  // [2][8 ch][YT][ZT]
  uint4* raw0 = reinterpret_cast<uint4*>(gbuf + 2 * W::GBUF);  // [DEPTH][RAW_ROWS][THREADS]
  float* diag = reinterpret_cast<float*>(raw0 + WT_DEPTH * W::RAW_ROWS * WT_THREADS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // block: (channel group, dy group, slot), channel groups fastest
  const int ncg = C / WT_WARPS;
  const int cg = blockIdx.x % ncg, rest = blockIdx.x / ncg;
  const int grp = rest % W::NGR, slot = rest / W::NGR;
  const int c0 = cg * WT_WARPS, dy0 = grp * DG;
  const int nzb = (Z + WT_ZT - 1) / WT_ZT, nyb = (Y + WT_YT - 1) / WT_YT;
  const long long plane = (long long)Y * Z * C;
  // ldmatrix.trans lanes, as dwconv3d_wgrad_tc_kernel's
  const int a_off = warp * W::PLANE + ((lane & 7) + ((lane >> 4) << 3)) * WT_ZP +
                    ((lane >> 3) & 1) * 8;
  const int g_off = warp * W::GPLANE + (lane & 15) * WT_ZT;

  // acc[dx][dy - dy0][band]: E over every unit of the block
  float acc[K][DG][NB][4];
#pragma unroll
  for (int dx = 0; dx < K; ++dx)
#pragma unroll
    for (int d = 0; d < DG; ++d)
#pragma unroll
      for (int bd = 0; bd < NB; ++bd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dx][d][bd][e] = 0.f;

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
    // the thread's input items: window row i / ZW (y0 - P + dy0 + row) and
    // column i % ZW (z0 - P + column), 8 channels of one voxel; -1 outside
    // the volume (staged as zeros) or past the window
    long long off[W::ITEMS];
    int dst[W::ITEMS];
#pragma unroll
    for (int j = 0; j < W::ITEMS; ++j) {
      const int i = tid + j * WT_THREADS;
      const int gy = y0 - P + dy0 + i / W::ZW, gz = z0 - P + i % W::ZW;
      const bool in = i < W::NITEM;
      off[j] = in && gy >= 0 && gy < Y && gz >= 0 && gz < Z
                   ? ((long long)gy * Z + gz) * C + c0 : -1;
      dst[j] = in ? (i / W::ZW) * WT_ZP + i % W::ZW : -1;
    }
    // the thread's cotangent item (threads < 128): row tid / 8, z tid % 8
    const int gy = y0 + tid / WT_ZT, gz = z0 + tid % WT_ZT;
    const long long goff =
        tid < WT_YT * WT_ZT && gy < Y && gz < Z ? ((long long)gy * Z + gz) * C + c0 : -1;
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
          for (int d = 0; d < DG; ++d) {
            uint32_t a[NB][4];
#pragma unroll
            for (int bd = 0; bd < NB; ++bd) ldmatrix_x4_trans(a[bd], pl + d * WT_ZP + 8 * bd);
#pragma unroll
            for (int dx = 0; dx < K; ++dx) {
              const int tg = t - dx;  // cotangent plane xs + tg
              if (tg >= 0 && tg < ng)
#pragma unroll
                for (int bd = 0; bd < NB; ++bd)
                  mma_bf16_16816(acc[dx][d][bd], a[bd], gfr[(rr - dx + K) % K][0],
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

  // dw[dx, dy, 8 band + i] = sum_j E_band[j + i][j]: the fragment through
  // shared memory, lane i adding its diagonal in the order j = 0, 1, ...
  const int gq = lane >> 2, q = lane & 3;
  float* dg = diag + warp * WT_ZW * WT_ZT;
  float* row = partial + (long long)slot * (K * K * K) * C + c0 + warp;
#pragma unroll
  for (int dx = 0; dx < K; ++dx)
#pragma unroll
    for (int d = 0; d < DG; ++d)
#pragma unroll
      for (int bd = 0; bd < NB; ++bd) {
        dg[gq * WT_ZT + 2 * q] = acc[dx][d][bd][0];
        dg[gq * WT_ZT + 2 * q + 1] = acc[dx][d][bd][1];
        dg[(gq + 8) * WT_ZT + 2 * q] = acc[dx][d][bd][2];
        dg[(gq + 8) * WT_ZT + 2 * q + 1] = acc[dx][d][bd][3];
        __syncwarp();
        const int nd = NB == 1 ? K : (bd == 0 ? 8 : K - 8);  // the band's taps
        if (lane < nd) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < WT_ZT; ++j) s += dg[(j + lane) * WT_ZT + j];
          row[(long long)((dx * K + dy0 + d) * K + 8 * bd + lane) * C] = s;
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

// ---- every other bf16 stem (C % 8 == 0, 8 <= C <= 256, odd k <= 15) -----------
//
// stem_wgrad_tc_kernel's products with N and k free. A product is, for one
// (dx, dy) item and one (x, y) column, E[m][c] = sum over 16 z of
// A[m][z] g[x, y, z0 + z, c], A a Hankel window of the input column x + dx,
// y + dy: PAIRED (k <= 7) rows m = dz of dy (0-7) and of dy + 1 (8-15), an
// item a dy pair; else (k >= 9) rows m = the 16 dz of one dy, an item a dy.
// N is a chunk of at most 64 channels as NT = 2, 4, 6 or 8 n8 tiles (a
// compile-time count; a chunk narrower than its class reads zero cotangent
// columns, whose sums are dropped), K the 16 z. A warp
// holds the sums of at most SWC_ACC / NT items (64 f32 a thread); a block
// of 8 warps one group of the k * (items of a dx) items and one channel
// chunk, walking (x, 16 y, 16 z) tiles of a persistent grid. Every (group,
// chunk) block of one slot walks the same tiles in the same order and
// writes its items' taps of its chunk to the slot's partial row, so each
// row is written whole and once, and wgrad_reduce_kernel adds the rows in
// its fixed order: the same result every run. A tile stages the
// cotangent's chunk (cp.async, 16-byte channel groups) and the input halo
// of the group's dx planes twice, the second copy shifted by one element,
// so a lane's z pair is one aligned 4-byte load (rows of 16 + 15 z + 1;
// the columns past 16 + k - 1 stay zero). In the 16-row form a lane's a1
// and a2 are the same pair (z = g + 2q + 8).
constexpr int SWC_WARPS = 8;
constexpr int SWC_THREADS = SWC_WARPS * 32;
constexpr int SWC_HZ = 32;    // halo row: 16 + 15 z, + 1 shift
constexpr int SWC_ACC = 16;   // items x n8 tiles of a warp's sums
constexpr int SWC_NTMAX = 8;  // n8 tiles of a chunk at most (64 channels)

template <int NT, bool PAIRED>
__global__ void __launch_bounds__(SWC_THREADS)
stem_wgrad_chunk_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                        float* __restrict__ partial, int B, int X, int Y, int Z, int C, int k,
                        int chunk, int S, int ngr, int copy) {
  constexpr int IPW = SWC_ACC / NT;  // items a warp at most
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* gs = reinterpret_cast<bf16*>(smem_raw);  // [16 y][16 z][S]
  bf16* halo = gs + SW_YT * SW_ZT * S;            // [2][copy]: [dx planes][HY][HZ] each
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, q = lane & 3;
  const int P = k / 2, HY = SW_YT + k - 1, HW = SW_ZT + k - 1;
  const int per_dx = PAIRED ? (k + 1) / 2 : k;  // items of one dx
  const int items = k * per_dx;
  const int nch = (C + chunk - 1) / chunk;
  const int gc = blockIdx.x % (ngr * nch), slot = blockIdx.x / (ngr * nch);
  const int grp = gc % ngr;
  const int c0 = (gc / ngr) * chunk, nt = min(chunk, C - c0) / 8;
  const int nper = gridDim.x / (ngr * nch);
  // the group's items i0 ... i1 - 1, dealt evenly to the warps; its dx planes
  const int ipg = (items + ngr - 1) / ngr;
  const int i0 = grp * ipg, i1 = min(items, i0 + ipg);
  const int ipw = (ipg + SWC_WARPS - 1) / SWC_WARPS;
  const int my0 = i0 + warp * ipw, myn = max(0, min(ipw, i1 - my0));
  const int dx_lo = i0 / per_dx, ndx = (i1 - 1) / per_dx - dx_lo + 1;
  // the item's first halo row (dx plane, dy) in the group's halo
  int hoff[IPW];
#pragma unroll
  for (int i = 0; i < IPW; ++i) {
    const int it = my0 + i, dx = it / per_dx, r = it % per_dx;
    hoff[i] = ((dx - dx_lo) * HY + (PAIRED ? 2 * r : r)) * SWC_HZ;
  }
  // zeros past the staged columns: the halo's, and the cotangent's past the
  // chunk (read as the class's zero columns)
  for (int i = tid; i < SW_YT * SW_ZT * S + 2 * copy; i += SWC_THREADS)
    gs[i] = __float2bfloat16_rn(0.f);
  // the lane's pair of z (2q, 2q + 1) + dz (= gq) starts at halo z gq + 2q:
  // even in copy 0, odd ones aligned in copy 1 (shifted by one)
  const bf16* hsrc = halo + (gq & 1) * (copy + 1) + gq + 2 * q;
  const int kr = (lane & 7) + ((lane >> 3) & 1) * 8, nc = (lane >> 4) * 8;

  float acc[IPW][NT][4];
#pragma unroll
  for (int i = 0; i < IPW; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

  const int nzt = (Z + SW_ZT - 1) / SW_ZT, nyt = (Y + SW_YT - 1) / SW_YT;
  const long long ntiles = (long long)B * X * nyt * nzt;
  for (long long tile = slot; tile < ntiles; tile += nper) {
    long long r = tile;
    const int zt = (int)(r % nzt);
    r /= nzt;
    const int yt = (int)(r % nyt);
    r /= nyt;
    const int xo = (int)(r % X);
    const int bi = (int)(r / X);
    const int z0 = zt * SW_ZT, y0 = yt * SW_YT;
    __syncthreads();  // every warp is done with the last tile
    // the cotangent's chunk, 16-byte pieces of 8 channels, zero outside
    for (int i = tid; i < SW_YT * SW_ZT * nt; i += SWC_THREADS) {
      const int piece = i % nt, v = i / nt, zz = v % SW_ZT, yy = v / SW_ZT;
      const int gy = y0 + yy, gz = z0 + zz;
      const bool ok = gy < Y && gz < Z;
      const bf16* src =
          ok ? g + ((((long long)bi * X + xo) * Y + gy) * Z + gz) * C + c0 + piece * 8 : g;
      cp_async16(gs + v * S + piece * 8, src, ok ? 16 : 0);
    }
    cp_async_commit();
    for (int i = tid; i < ndx * HY * HW; i += SWC_THREADS) {
      const int hz = i % HW;
      const int rest = i / HW;
      const int hy = rest % HY, hx = rest / HY;
      const int gx = xo - P + dx_lo + hx, gy = y0 - P + hy, gz = z0 - P + hz;
      bf16 v = __float2bfloat16_rn(0.f);
      if (gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z)
        v = x[(((long long)bi * X + gx) * Y + gy) * Z + gz];
      const int o = (hx * HY + hy) * SWC_HZ + hz;
      halo[o] = v;
      halo[copy + o + 1] = v;
    }
    cp_async_wait_all();
    __syncthreads();
    const int ny = min(SW_YT, Y - y0);
    for (int yy = 0; yy < ny; ++yy) {
      uint32_t bb[NT / 2][4];
#pragma unroll
      for (int nb = 0; nb < NT / 2; ++nb)
        ldmatrix_x4_trans(bb[nb], gs + (yy * SW_ZT + kr) * S + nb * 16 + nc);
#pragma unroll
      for (int i = 0; i < IPW; ++i) {
        if (i >= myn) break;
        const bf16* r0 = hsrc + hoff[i] + yy * SWC_HZ;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(r0);
        if constexpr (PAIRED) {
          a[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
          // a pair's second dy past k reads the row after the plane (within
          // the halo's padding): its rows 8-15 are dropped
          a[1] = *reinterpret_cast<const uint32_t*>(r0 + SWC_HZ);
          a[3] = *reinterpret_cast<const uint32_t*>(r0 + SWC_HZ + 8);
        } else {
          a[1] = a[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        }
#pragma unroll
        for (int nb = 0; nb < NT / 2; ++nb) {
          mma_bf16_16816(acc[i][2 * nb], a, bb[nb][0], bb[nb][1]);
          mma_bf16_16816(acc[i][2 * nb + 1], a, bb[nb][2], bb[nb][3]);
        }
      }
    }
  }

  // the slot's row: tap (dx, dy, dz), channels c0 + n * 8 + 2q, + 1
  float* row = partial + (long long)slot * k * k * k * C + c0 + 2 * q;
#pragma unroll
  for (int i = 0; i < IPW; ++i) {
    if (i >= myn) break;
    const int it = my0 + i, dx = it / per_dx, r = it % per_dx;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int dy = PAIRED ? 2 * r + h : r, dz = PAIRED ? gq : gq + 8 * h;
      if (dy >= k || dz >= k) continue;
      float* o = row + (long long)((dx * k + dy) * k + dz) * C;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n < nt)
          *reinterpret_cast<float2*>(o + n * 8) =
              make_float2(acc[i][n][2 * h], acc[i][n][2 * h + 1]);
    }
  }
}

// ---- launch plans ---------------------------------------------------------------

enum Path {
  FP32 = 0, DEPTHWISE_TC = 1, STEM_TC = 2, ANY_K = 3, STEM_CHUNK = 4, DEPTHWISE_BIG = 5
};

// what a call launches, from make_plan; the caller keeps it as int32
// [PLAN_INTS] (skoots_dwconv3d_wgrad_plan) and hands it to every launch at
// the same operands, so a call plans nothing
struct Plan {
  int path = FP32;
  int rows = 0;   // rows of the partial buffer (= blocks, or tiles of the FP32 kernel)
  int grid = 0;
  int nxs = 1, xt = 1, units = 0, nper = 0;  // the depthwise tensor-core kernels
                                             // (ANY_K: xt (b, x) planes a row)
  int smem = 0;
  int chunk = 0, stride = 0, ngr = 0, copy = 0;  // STEM_CHUNK: channels a block,
                                                 // their row stride, item groups,
                                                 // one halo copy (elements);
                                                 // DEPTHWISE_BIG: ngr dy groups
};
constexpr int PLAN_INTS = 12;
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

// The kernel a launch takes: the one decision the plan and the route query
// share. A bf16 stem with C % 8 == 0, 8 <= C <= 256 and k <= 15 runs a stem
// GEMM on the tensor cores (the 32-channel templates at k = 3, 5, 7); every
// other k = 3, 5, 7 the depthwise tensor-core kernel (bf16 16-byte channel
// groups, aligned, Y Z C < 2^31: the name given is for such operands) or the
// FP32 kernel; a bf16 depthwise layer with C % 8 == 0 at k = 9 to 15
// `dwconv3d_wgrad_big_kernel` (16-byte-aligned operands, else the plan
// raises); every other odd k the run-time-k kernel.
enum Route { R_NONE, R_STEM32, R_STEM_CHUNK, R_TC, R_FP32, R_BIG, R_ANY };

Route route(int dtype, long long x_cstride, int C, int k) {
  if (k < 3 || k % 2 == 0 || C < 1 || (dtype != SKOOTS_BF16 && dtype != SKOOTS_F32))
    return R_NONE;
  if (dtype == SKOOTS_BF16 && x_cstride == 0 && C % 8 == 0 && C >= 8 && C <= 256 && k <= 15)
    return C == SW_C && k <= 7 ? R_STEM32 : R_STEM_CHUNK;
  if (k > 7)
    return dtype == SKOOTS_BF16 && x_cstride == 1 && C % WT_WARPS == 0 && k <= 15 ? R_BIG
                                                                                   : R_ANY;
  return dtype == SKOOTS_BF16 && x_cstride == 1 && C % WT_WARPS == 0 ? R_TC : R_FP32;
}

// stem_wgrad_chunk_kernel's chunk of C: at most 64 channels, the chunks as
// even as 8-channel units allow
int wgrad_chunk(int C) {
  const int units = C / 8, n = (units + SWC_NTMAX - 1) / SWC_NTMAX;
  return 8 * ((units + n - 1) / n);
}

const char* route_name(Route r, int dtype, int C, int k) {
  static const char* const stem32[] = {"stem_wgrad_tc_kernel<3>", "stem_wgrad_tc_kernel<5>",
                                       "stem_wgrad_tc_kernel<7>"};
  static const char* const chunk[4][2] = {
      {"stem_wgrad_chunk_kernel<2,0>", "stem_wgrad_chunk_kernel<2,1>"},
      {"stem_wgrad_chunk_kernel<4,0>", "stem_wgrad_chunk_kernel<4,1>"},
      {"stem_wgrad_chunk_kernel<6,0>", "stem_wgrad_chunk_kernel<6,1>"},
      {"stem_wgrad_chunk_kernel<8,0>", "stem_wgrad_chunk_kernel<8,1>"}};
  static const char* const tc[] = {"dwconv3d_wgrad_tc_kernel<3>", "dwconv3d_wgrad_tc_kernel<5>",
                                   "dwconv3d_wgrad_tc_kernel<7>"};
  static const char* const fp32[2][3] = {
      {"dwconv3d_wgrad_kernel<float,3>", "dwconv3d_wgrad_kernel<float,5>",
       "dwconv3d_wgrad_kernel<float,7>"},
      {"dwconv3d_wgrad_kernel<bf16,3>", "dwconv3d_wgrad_kernel<bf16,5>",
       "dwconv3d_wgrad_kernel<bf16,7>"}};
  static const char* const big[] = {"dwconv3d_wgrad_big_kernel<9>", "dwconv3d_wgrad_big_kernel<11>",
                                    "dwconv3d_wgrad_big_kernel<13>",
                                    "dwconv3d_wgrad_big_kernel<15>"};
  static const char* const any[2] = {"dwconv3d_wgrad_any_kernel<float>",
                                     "dwconv3d_wgrad_any_kernel<bf16>"};
  const int ki = (k - 3) / 2;
  switch (r) {
    case R_STEM32: return stem32[ki];
    case R_STEM_CHUNK: {
      const int nt = stem_nt_class(wgrad_chunk(C) / 8);
      return chunk[nt / 2 - 1][k <= 7];
    }
    case R_TC: return tc[ki];
    case R_FP32: return fp32[dtype == SKOOTS_BF16][ki];
    case R_BIG: return big[ki - 3];
    case R_ANY: return any[dtype == SKOOTS_BF16];
    default: return nullptr;
  }
}

// the instantiation for an n8-tile class and k <= 7 (paired rows)
auto stem_wgrad_chunk_of(int nt, bool paired) {
  return paired ? (nt == 2   ? stem_wgrad_chunk_kernel<2, true>
                   : nt == 4 ? stem_wgrad_chunk_kernel<4, true>
                   : nt == 6 ? stem_wgrad_chunk_kernel<6, true>
                             : stem_wgrad_chunk_kernel<8, true>)
                : (nt == 2   ? stem_wgrad_chunk_kernel<2, false>
                   : nt == 4 ? stem_wgrad_chunk_kernel<4, false>
                   : nt == 6 ? stem_wgrad_chunk_kernel<6, false>
                             : stem_wgrad_chunk_kernel<8, false>);
}

// the plan of stem_wgrad_chunk_kernel at (B, X, Y, Z, C, k)
cudaError_t make_plan_stem_chunk(int B, int X, int Y, int Z, int C, int k, Plan* plan) {
  Plan p;
  p.path = STEM_CHUNK;
  p.chunk = wgrad_chunk(C);
  const int nt = stem_nt_class(p.chunk / 8), nch = (C + p.chunk - 1) / p.chunk;
  p.stride = stem_row_stride(nt);
  const bool paired = k <= 7;
  const int per_dx = paired ? (k + 1) / 2 : k, items = k * per_dx;
  const int ipb = SWC_WARPS * (SWC_ACC / nt);  // items a block at most
  p.ngr = (items + ipb - 1) / ipb;
  // the most dx planes a group's items span, and one halo copy of them
  // (padded: a pair's second dy past k reads a row past the last plane)
  const int ipg = (items + p.ngr - 1) / p.ngr;
  int ndx = 1;
  for (int grp = 0; grp < p.ngr; ++grp) {
    const int i0 = grp * ipg, i1 = i0 + ipg < items ? i0 + ipg : items;
    const int n = (i1 - 1) / per_dx - i0 / per_dx + 1;
    ndx = n > ndx ? n : ndx;
  }
  p.copy = (ndx * (SW_YT + k - 1) * SWC_HZ + 2 * SWC_HZ + 63) / 64 * 64 + 32;
  p.smem = (SW_YT * SW_ZT * p.stride + 2 * p.copy) * 2;
  const long long tiles = (long long)B * X * ((Y + SW_YT - 1) / SW_YT) *
                          ((Z + SW_ZT - 1) / SW_ZT);
  long long cap = 0;
  const int e = persistent_grid(stem_wgrad_chunk_of(nt, paired), SWC_THREADS, p.smem,
                                1LL << 40, &cap);
  if (e) return (cudaError_t)e;
  // slots (partial rows): a wave of the card shared among the (group, chunk)
  // blocks of a slot, at most a tile each
  long long nper = cap / ((long long)p.ngr * nch);
  nper = nper < 1 ? 1 : (nper > tiles ? tiles : nper);
  p.nper = p.rows = (int)nper;
  p.grid = (int)(nper * p.ngr * nch);
  *plan = p;
  return cudaSuccess;
}

// The units of the depthwise tensor-core kernels: `target` blocks a
// (channel group[, dy group]) and common.cuh::split_x's X split (a unit of
// xt cotangent planes); into p's nxs, xt, units, nper. False where no split
// keeps the units under 2^31.
bool split_units(long long cols, int X, long long target, int k, Plan& p) {
  XSplit s;
  if (!split_x(cols, X, target, k, 1, &s)) return false;
  p.nxs = s.nxs;
  p.xt = s.xt;
  p.units = (int)s.units;
  p.nper = (int)((s.units + s.per_block - 1) / s.per_block);
  return true;
}

// the plan of dwconv3d_wgrad_big_kernel<K>: blocks a (channel group, dy
// group) one wave of the card
template <int K>
cudaError_t make_plan_big(int B, int X, int Y, int Z, int C, Plan* plan) {
  using W = WgBig<K>;
  Plan p;
  p.path = DEPTHWISE_BIG;
  p.smem = W::SMEM;
  p.ngr = W::NGR;
  int sms = 0, per_sm = 0;
  const cudaError_t e = occupancy<DEPTHWISE_BIG * 16 + K>(dwconv3d_wgrad_big_kernel<K>,
                                                          WT_THREADS, p.smem, &sms, &per_sm);
  if (e != cudaSuccess) return e;
  const long long groups = (long long)(C / WT_WARPS) * W::NGR;
  const long long target_ll = (long long)sms * per_sm / groups;
  const long long target = target_ll < 1 ? 1 : target_ll;
  const long long cols = (long long)B * ((Y + WT_YT - 1) / WT_YT) * ((Z + WT_ZT - 1) / WT_ZT);
  if (!split_units(cols, X, target, K, p)) return cudaErrorInvalidValue;
  p.rows = p.nper;
  p.grid = (int)(groups * p.nper);
  *plan = p;
  return cudaSuccess;
}

template <int K>
int launch_big(const void* x, const void* g, float* partial, float* out, int X, int Y, int Z,
               int C, const Plan& p, cudaStream_t stream) {
  if (p.rows > 0) {
    dwconv3d_wgrad_big_kernel<K><<<p.grid, WT_THREADS, p.smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g), partial, X, Y, Z, C, p.nxs,
        p.xt, p.units, p.nper);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int n = K * K * K * C;
  wgrad_reduce_kernel<<<(n + RED_COLS - 1) / RED_COLS, RED_ROWS * RED_COLS, 0, stream>>>(
      partial, out, p.rows, n);
  return (int)cudaGetLastError();
}

// 16-byte channel groups of x and g (the big kernels' operands)
bool big_operands(const void* x, const void* g, int C, long long x_vstride) {
  return x_vstride == C && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(g) % 16 == 0;
}

template <typename T, int K>
cudaError_t make_plan(const void* x, const void* g, int B, int X, int Y, int Z, int C,
                      long long x_vstride, long long x_cstride, Plan* plan) {
  Plan p;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const bool bf = sizeof(T) == 2;
  cudaError_t e = cudaSuccess;
  if (bf && x_cstride == 0 && C == SW_C) {
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
    // blocks a channel group: one wave of the card
    const int ncg = C / WT_WARPS;
    const long long target_ll = (long long)sms * per_sm / ncg;
    const long long target = target_ll < 1 ? 1 : target_ll;
    const long long cols =
        (long long)B * ((Y + WT_YT - 1) / WT_YT) * ((Z + WT_ZT - 1) / WT_ZT);
    split_units(cols, X, target, K, p);
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

int launch_stem_chunk(int k, const void* x, const void* g, float* partial, float* out, int B,
                      int X, int Y, int Z, int C, const Plan& p, cudaStream_t stream) {
  const int n = k * k * k * C;
  if (p.rows > 0) {
    stem_wgrad_chunk_of(stem_nt_class(p.chunk / 8), k <= 7)<<<p.grid, SWC_THREADS, p.smem,
                                                                stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g), partial, B, X, Y, Z, C, k,
        p.chunk, p.stride, p.ngr, p.copy);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  wgrad_reduce_kernel<<<(n + RED_COLS - 1) / RED_COLS, RED_ROWS * RED_COLS, 0, stream>>>(
      partial, out, p.rows, n);
  return (int)cudaGetLastError();
}

// ---- any other odd k: a thread a weight-gradient entry of a row ------------------
//
// JAX's schema takes any odd KERNEL_SIZE >= 3; the depthwise kernels above
// instantiate 3, 5 and 7, the stems' GEMMs take bf16 stems to k = 15. Every
// other odd k runs
// `dwconv3d_wgrad_any_kernel`: k a run-time value; partial row r owns the
// (b, x) planes r * xt ... of the batch, and thread (r, e) sums over them,
// in (b, x, y, z) order, the products of entry e = ((dx k + dy) k + dz) C + c
// (channels fastest, so a warp reads neighbouring channels of a voxel through
// the cache); the rows then add in wgrad_reduce_kernel's fixed order.
constexpr int ANY_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(ANY_THREADS)
dwconv3d_wgrad_any_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          float* __restrict__ partial, int B, int X, int Y, int Z, int C,
                          int k, long long x_vstride, long long x_cstride, int xt) {
  const int n = k * k * k * C;
  const int e = blockIdx.x * ANY_THREADS + threadIdx.x;
  if (e >= n) return;
  const int r = blockIdx.y;
  const int c = e % C;
  int t = e / C;
  const int dz = t % k;
  t /= k;
  const int dy = t % k;
  const int dx = t / k;
  const int P = k / 2;
  // output z whose input z + dz - P lies in the volume
  const int z0 = P - dz > 0 ? P - dz : 0;
  const int z1 = Z + P - dz < Z ? Z + P - dz : Z;
  const long long planes = (long long)B * X;
  const long long p1 = (long long)(r + 1) * xt < planes ? (long long)(r + 1) * xt : planes;
  float acc = 0.f;
  for (long long p = (long long)r * xt; p < p1; ++p) {
    const long long bi = p / X;
    const int xi = (int)(p % X);
    const int gx = xi + dx - P;
    if (gx < 0 || gx >= X) continue;
    const T* xb = x + ((bi * X + gx) * Y) * Z * x_vstride + c * x_cstride;
    const T* gb = g + ((bi * X + xi) * Y) * Z * C + c;
    for (int y = 0; y < Y; ++y) {
      const int gy = y + dy - P;
      if (gy < 0 || gy >= Y) continue;
      const T* xr = xb + (long long)gy * Z * x_vstride;
      const T* gr = gb + (long long)y * Z * C;
      for (int z = z0; z < z1; ++z)
        acc = fmaf(to_f32<T>(xr[(z + dz - P) * x_vstride]), to_f32<T>(gr[(long long)z * C]),
                   acc);
    }
  }
  partial[(long long)r * n + e] = acc;
}

template <typename T>
cudaError_t make_plan_any(int k, int B, int X, int C, Plan* plan) {
  Plan p;
  p.path = ANY_K;
  const long long planes = (long long)B * X;
  if (planes > 0 && C > 0) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    // about two waves of 2048 threads an SM, at most a row a plane
    const long long n = (long long)k * k * k * C;
    long long rows = 2LL * sms * 2048 / n;
    rows = rows < 1 ? 1 : (rows > planes ? planes : rows);
    p.xt = (int)((planes + rows - 1) / rows);
    p.rows = (int)((planes + p.xt - 1) / p.xt);
    p.grid = (int)((n + ANY_THREADS - 1) / ANY_THREADS);
  }
  *plan = p;
  return cudaSuccess;
}

template <typename T>
int launch_any(int k, const void* x, const void* g, float* partial, float* out, int B, int X,
               int Y, int Z, int C, long long x_vstride, long long x_cstride, const Plan& p,
               cudaStream_t stream) {
  const int n = k * k * k * C;
  if (p.rows > 0 && (long long)Y * Z > 0) {
    dwconv3d_wgrad_any_kernel<T><<<dim3(p.grid, p.rows), ANY_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), partial, B, X, Y, Z, C, k,
        x_vstride, x_cstride, p.xt);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  wgrad_reduce_kernel<<<(n + RED_COLS - 1) / RED_COLS, RED_ROWS * RED_COLS, 0, stream>>>(
      partial, out, (long long)Y * Z > 0 ? p.rows : 0, n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_launch(int k, const void* x, const void* g, float* partial, float* out, int B,
                    int X, int Y, int Z, int C, long long x_vstride, long long x_cstride,
                    const Plan& p, cudaStream_t s) {
  if (p.path == STEM_CHUNK) {
    if (route(sizeof(T) == 2 ? SKOOTS_BF16 : SKOOTS_F32, x_cstride, C, k) != R_STEM_CHUNK ||
        reinterpret_cast<uintptr_t>(g) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return launch_stem_chunk(k, x, g, partial, out, B, X, Y, Z, C, p, s);
  }
  if (p.path == DEPTHWISE_BIG) {
    if (route(sizeof(T) == 2 ? SKOOTS_BF16 : SKOOTS_F32, x_cstride, C, k) != R_BIG ||
        !big_operands(x, g, C, x_vstride) || p.ngr != (k == 9 ? 3 : k))
      return (int)cudaErrorInvalidValue;
    switch (k) {
      case 9: return launch_big<9>(x, g, partial, out, X, Y, Z, C, p, s);
      case 11: return launch_big<11>(x, g, partial, out, X, Y, Z, C, p, s);
      case 13: return launch_big<13>(x, g, partial, out, X, Y, Z, C, p, s);
      default: return launch_big<15>(x, g, partial, out, X, Y, Z, C, p, s);
    }
  }
  if (p.path == ANY_K)
    return launch_any<T>(k, x, g, partial, out, B, X, Y, Z, C, x_vstride, x_cstride, p, s);
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
  const Route r = route(sizeof(T) == 2 ? SKOOTS_BF16 : SKOOTS_F32, x_cstride, C, k);
  if (r == R_NONE) return cudaErrorInvalidValue;
  if ((long long)B * X * Y * Z * C == 0) {  // no products: only the reduce, of 0 rows
    *p = Plan();
    p->path = k <= 7 ? FP32 : ANY_K;
    return cudaSuccess;
  }
  if (r == R_STEM32 || r == R_STEM_CHUNK) {
    // the stems read x as single bf16 values and g as 16-byte channel
    // groups: no other kernel takes them
    if (x_vstride != 1 || reinterpret_cast<uintptr_t>(g) % 16 != 0) return cudaErrorInvalidValue;
    if (r == R_STEM_CHUNK) return make_plan_stem_chunk(B, X, Y, Z, C, k, p);
  }
  if (r == R_BIG) {
    if (!big_operands(x, g, C, x_vstride)) return cudaErrorInvalidValue;
    switch (k) {
      case 9: return make_plan_big<9>(B, X, Y, Z, C, p);
      case 11: return make_plan_big<11>(B, X, Y, Z, C, p);
      case 13: return make_plan_big<13>(B, X, Y, Z, C, p);
      default: return make_plan_big<15>(B, X, Y, Z, C, p);
    }
  }
  if (r == R_ANY) return make_plan_any<T>(k, B, X, C, p);
  switch (k) {
    case 3: return make_plan<T, 3>(x, g, B, X, Y, Z, C, x_vstride, x_cstride, p);
    case 5: return make_plan<T, 5>(x, g, B, X, Y, Z, C, x_vstride, x_cstride, p);
    default: return make_plan<T, 7>(x, g, B, X, Y, Z, C, x_vstride, x_cstride, p);
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
  if (p.path < FP32 || p.path > DEPTHWISE_BIG || p.rows < 0) return (int)cudaErrorInvalidValue;
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

// The kernel skoots_dwconv3d_wgrad takes at (dtype, x_cstride, C, k) for
// contiguous 16-byte-aligned operands, by name ("stem_wgrad_chunk_kernel<2,0>",
// "dwconv3d_wgrad_tc_kernel<7>", "dwconv3d_wgrad_big_kernel<9>",
// "dwconv3d_wgrad_any_kernel<bf16>", ...), or
// null where it refuses them. A pure function of its integers.
extern "C" const char* skoots_dwconv3d_wgrad_route(int dtype, int x_cstride, int C, int k) {
  return route_name(route(dtype, x_cstride, C, k), dtype, C, k);
}
