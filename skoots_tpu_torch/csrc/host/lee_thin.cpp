// Lee 3D medial-axis thinning on the host, for ground-truth skeletons
// (skoots_tpu_torch/train/generate_skeletons.py, --skeletonize-method lee).
// A copy of native/skoots_native.cpp::lee_thin_3d and its helpers, so the
// port builds and loads it without the JAX package
// (skoots_tpu_torch/utils/lee_thin.py: g++ -O3 -shared -fPIC at first use).
// Plain C ABI for ctypes; host code, not on the device path.

#include <cstdint>
#include <vector>

extern "C" {

// 3D medial-axis thinning: the Lee-Kashyap-Chu (1994) framework the
// original SKOOTS gets from skimage.morphology.skeletonize_3d
// (its train/generate_skeletons.py:138) — iterative
// 6-subiteration border peeling, endpoint preservation, and
// topology-preserving deletion with sequential re-checking. The per-voxel
// deletability test uses the (26,6) simple-point characterization
// (Bertrand & Malandain: exactly one 26-connected object component in
// N26*(p), and the background 6-neighbors of p all lie in one 6-connected
// background component of N18(p)) — equivalent to the paper's Euler-LUT +
// octree-recursion pair, without transcribing its tables.

static inline int nb_index(int di, int dj, int dk) {
    return (di + 1) * 9 + (dj + 1) * 3 + (dk + 1);
}

// gather the 3x3x3 neighborhood of (i,j,k); out-of-volume = background
static void lee_gather(const uint8_t* v, int64_t i, int64_t j, int64_t k,
                       int64_t x, int64_t y, int64_t z, uint8_t nb[27]) {
    int t = 0;
    for (int di = -1; di <= 1; ++di)
        for (int dj = -1; dj <= 1; ++dj)
            for (int dk = -1; dk <= 1; ++dk, ++t) {
                const int64_t ni = i + di, nj = j + dj, nk = k + dk;
                nb[t] = (ni >= 0 && nj >= 0 && nk >= 0 && ni < x && nj < y &&
                         nk < z && v[(ni * y + nj) * z + nk])
                            ? 1 : 0;
            }
}

// object voxels of N26*(p) form exactly one 26-connected component
static bool lee_one_object_comp(const uint8_t nb[27]) {
    int total = 0, start = -1;
    for (int t = 0; t < 27; ++t)
        if (t != 13 && nb[t]) { ++total; if (start < 0) start = t; }
    if (total == 0) return false;
    bool seen[27] = {false};
    int stack[26], sp = 0, cnt = 0;
    stack[sp++] = start;
    seen[start] = true;
    while (sp) {
        const int t = stack[--sp];
        ++cnt;
        const int ti = t / 9 - 1, tj = (t / 3) % 3 - 1, tk = t % 3 - 1;
        for (int di = -1; di <= 1; ++di)
            for (int dj = -1; dj <= 1; ++dj)
                for (int dk = -1; dk <= 1; ++dk) {
                    const int ni = ti + di, nj = tj + dj, nk = tk + dk;
                    if (ni < -1 || ni > 1 || nj < -1 || nj > 1 || nk < -1 ||
                        nk > 1)
                        continue;
                    const int u = nb_index(ni, nj, nk);
                    if (u == 13 || seen[u] || !nb[u]) continue;
                    seen[u] = true;
                    stack[sp++] = u;
                }
    }
    return cnt == total;
}

// all background 6-neighbors of p lie in ONE 6-connected background
// component of N18(p) (corners and center excluded from the walk)
static bool lee_one_bg_comp(const uint8_t nb[27]) {
    static const int faces[6] = {nb_index(1, 0, 0),  nb_index(-1, 0, 0),
                                 nb_index(0, 1, 0),  nb_index(0, -1, 0),
                                 nb_index(0, 0, 1),  nb_index(0, 0, -1)};
    int seed = -1, n_bg_faces = 0;
    for (int f = 0; f < 6; ++f)
        if (!nb[faces[f]]) { ++n_bg_faces; if (seed < 0) seed = faces[f]; }
    if (n_bg_faces == 0) return false;
    bool seen[27] = {false};
    int stack[18], sp = 0;
    stack[sp++] = seed;
    seen[seed] = true;
    while (sp) {
        const int t = stack[--sp];
        const int ti = t / 9 - 1, tj = (t / 3) % 3 - 1, tk = t % 3 - 1;
        static const int d6[6][3] = {{1, 0, 0},  {-1, 0, 0}, {0, 1, 0},
                                     {0, -1, 0}, {0, 0, 1},  {0, 0, -1}};
        for (auto& o : d6) {
            const int ni = ti + o[0], nj = tj + o[1], nk = tk + o[2];
            if (ni < -1 || ni > 1 || nj < -1 || nj > 1 || nk < -1 || nk > 1)
                continue;
            const int manh = (ni < 0 ? -ni : ni) + (nj < 0 ? -nj : nj) +
                             (nk < 0 ? -nk : nk);
            if (manh == 0 || manh == 3) continue;  // center / corner: not N18
            const int u = nb_index(ni, nj, nk);
            if (seen[u] || nb[u]) continue;
            seen[u] = true;
            stack[sp++] = u;
        }
    }
    for (int f = 0; f < 6; ++f)
        if (!nb[faces[f]] && !seen[faces[f]]) return false;
    return true;
}

static bool lee_deletable(const uint8_t* v, int64_t i, int64_t j, int64_t k,
                          int64_t x, int64_t y, int64_t z) {
    uint8_t nb[27];
    lee_gather(v, i, j, k, x, y, z, nb);
    int nc = 0;
    for (int t = 0; t < 27; ++t)
        if (t != 13 && nb[t]) ++nc;
    if (nc < 2) return false;  // endpoint (or isolated): preserve
    return lee_one_object_comp(nb) && lee_one_bg_comp(nb);
}

// In-place 3D medial-axis thinning of a uint8 mask (nonzero = object).
// Returns the number of voxels deleted.
int64_t lee_thin_3d(uint8_t* vol, int64_t x, int64_t y, int64_t z) {
    static const int dirs[6][3] = {{0, 0, 1}, {0, 0, -1}, {0, -1, 0},
                                   {0, 1, 0}, {1, 0, 0},  {-1, 0, 0}};
    std::vector<int64_t> cand;
    int64_t deleted = 0;
    bool changed = true;
    while (changed) {
        changed = false;
        for (auto& dir : dirs) {
            cand.clear();
            for (int64_t i = 0; i < x; ++i)
                for (int64_t j = 0; j < y; ++j)
                    for (int64_t k = 0; k < z; ++k) {
                        const int64_t idx = (i * y + j) * z + k;
                        if (!vol[idx]) continue;
                        const int64_t ni = i + dir[0], nj = j + dir[1],
                                      nk = k + dir[2];
                        const bool bg_nb =
                            !(ni >= 0 && nj >= 0 && nk >= 0 && ni < x &&
                              nj < y && nk < z &&
                              vol[(ni * y + nj) * z + nk]);
                        if (!bg_nb) continue;  // not a border point this pass
                        // require object support on the OPPOSITE side: a
                        // direction-d peel may take at most one layer off a
                        // d-facing surface. Without this, the sequential
                        // recheck can zipper a 1-voxel-thick ribbon end to
                        // end through cascading simple-point deletions
                        // (measured: even-diameter cylinders collapse from
                        // a full centerline to 2 voxels).
                        const int64_t oi = i - dir[0], oj = j - dir[1],
                                      ok_ = k - dir[2];
                        const bool obj_opp =
                            oi >= 0 && oj >= 0 && ok_ >= 0 && oi < x &&
                            oj < y && ok_ < z &&
                            vol[(oi * y + oj) * z + ok_];
                        if (!obj_opp) continue;
                        if (lee_deletable(vol, i, j, k, x, y, z))
                            cand.push_back(idx);
                    }
            // sequential re-check: simultaneous deletion of two adjacent
            // simple points can break connectivity (Lee 1994 sec. 4)
            for (const int64_t idx : cand) {
                const int64_t k2 = idx % z, j2 = (idx / z) % y,
                              i2 = idx / (z * y);
                if (lee_deletable(vol, i2, j2, k2, x, y, z)) {
                    vol[idx] = 0;
                    ++deleted;
                    changed = true;
                }
            }
        }
    }
    return deleted;
}

}  // extern "C"
