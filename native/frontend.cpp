// Host-side scan frontend: filter + transform + voxel binning in native code.
//
// The reference performs filterAndTransform + VoxelGridWeighted on the CPU
// (src/vofod_nodelet.cpp:619-686, src/voxel_grid_weighted.cpp:119-190); this
// is this framework's equivalent for the PREBINNED ingest path: the host
// bins each scan into a packed dense uint8 count grid (low 6 bits = filtered
// point count clamped to 63 — the EMA weight 2^-count is f32-identical
// beyond that — bit 7 = any-return blocker flag) that rides the device
// upload, so the device-side frontend collapses to a pure elementwise unpack
// (pipeline/frontend.py run_frontend_prebinned).  This removes the
// histogram scatter — the single most expensive op in the device step, the
// one XLA cannot reshape (serialized ~8 ns/update, DESIGN.md §1) — from the
// device entirely.
//
// Float semantics mirror vofod_tpu/pipeline/frontend.py + ops/binning.py
// exactly (f32 arithmetic, same op order; build with -ffp-contract=off so the
// compiler cannot fuse a*b+c differently than XLA does).
//
// C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Points are stored SoA (x/y/z planes) so the per-point index computation
// vectorizes; the chunk scratch keeps pass-1 outputs L1-resident between the
// vector pass and the scalar scatter pass.
constexpr int64_t kChunk = 4096;

struct Binner {
  int64_t n_points;
  std::vector<float> dx, dy, dz;  // [N] ray directions (SoA)
  std::vector<float> ox, oy, oz;  // [N] ray offsets (SoA)
  std::vector<uint8_t> mask;      // [N] FOV mask (1 = usable)
  float excl_lo[3], excl_hi[3];
  float op_lo[3], op_hi[3];
  float origin[3];
  int32_t nx, ny, nz;
  float inv_voxel;
  // per-chunk scratch: voxel id (-1 = filtered out; bit 30 = exclude-box)
  std::vector<int32_t> fid_buf;
};

}  // namespace

extern "C" {

void* vofod_binner_create(const float* dirs, const float* offs,
                          int64_t n_points, const uint8_t* mask,
                          const float* excl_lo, const float* excl_hi,
                          const float* op_lo, const float* op_hi,
                          const float* grid_origin, int32_t nx, int32_t ny,
                          int32_t nz, float voxel_size) {
  auto* b = new Binner();
  b->n_points = n_points;
  b->dx.resize(n_points);
  b->dy.resize(n_points);
  b->dz.resize(n_points);
  b->ox.resize(n_points);
  b->oy.resize(n_points);
  b->oz.resize(n_points);
  for (int64_t i = 0; i < n_points; ++i) {
    b->dx[i] = dirs[3 * i + 0];
    b->dy[i] = dirs[3 * i + 1];
    b->dz[i] = dirs[3 * i + 2];
    b->ox[i] = offs[3 * i + 0];
    b->oy[i] = offs[3 * i + 1];
    b->oz[i] = offs[3 * i + 2];
  }
  if (mask) {
    b->mask.assign(mask, mask + n_points);
  } else {
    b->mask.assign(n_points, 1);
  }
  b->fid_buf.resize(kChunk);
  std::memcpy(b->excl_lo, excl_lo, sizeof b->excl_lo);
  std::memcpy(b->excl_hi, excl_hi, sizeof b->excl_hi);
  std::memcpy(b->op_lo, op_lo, sizeof b->op_lo);
  std::memcpy(b->op_hi, op_hi, sizeof b->op_hi);
  std::memcpy(b->origin, grid_origin, sizeof b->origin);
  b->nx = nx;
  b->ny = ny;
  b->nz = nz;
  b->inv_voxel = 1.0f / voxel_size;
  return b;
}

void vofod_binner_destroy(void* vb) { delete static_cast<Binner*>(vb); }

// Bin one scan into a packed dense uint8 grid.
//
// ranges_mm [N] (0 = no return); intensity [N] or NULL (treated as +inf);
// pose = 16 floats row-major world_T_sensor.
//
// Outputs:
//   out_grid [n_voxels] (z-major, x fastest): low 6 bits = filtered point
//     count clamped to 63 (the EMA weight 2^-count is f32-identical beyond
//     25, see pipeline/background.py clamp at ref :776-796), bit 7 =
//     any-return blocker flag (own-airframe hits included — they truncate
//     rays in the reference too, vofod_nodelet.cpp:1455).  Zeroed here.
//   out_active [N] or NULL: per-pixel raycast gate, the reference's skip
//     rule `intensity < min_int || (!mask && range == 0)` negated (:1449-1450).
//   out_stats [2] or NULL: {n_valid_points, n_exclude_hits} (true point
//     counts, unclamped).
void vofod_binner_bin_dense(void* vb, const uint32_t* ranges_mm,
                            const float* intensity, const float* pose,
                            float min_intensity, uint8_t* out_grid,
                            uint8_t* out_active, int32_t* out_stats) {
  auto* b = static_cast<Binner*>(vb);
  const float r00 = pose[0], r01 = pose[1], r02 = pose[2], tx = pose[3];
  const float r10 = pose[4], r11 = pose[5], r12 = pose[6], ty = pose[7];
  const float r20 = pose[8], r21 = pose[9], r22 = pose[10], tz = pose[11];
  const int64_t nv = int64_t(b->nx) * b->ny * b->nz;
  std::memset(out_grid, 0, size_t(nv));
  int32_t n_valid = 0, n_excl = 0;

  const float elx = b->excl_lo[0], ely = b->excl_lo[1], elz = b->excl_lo[2];
  const float ehx = b->excl_hi[0], ehy = b->excl_hi[1], ehz = b->excl_hi[2];
  const float plx = b->op_lo[0], ply = b->op_lo[1], plz = b->op_lo[2];
  const float phx = b->op_hi[0], phy = b->op_hi[1], phz = b->op_hi[2];
  const float gox = b->origin[0], goy = b->origin[1], goz = b->origin[2];
  const float ivx = b->inv_voxel;
  const int32_t nx = b->nx, ny = b->ny, nz = b->nz;
  int32_t* const fid_buf = b->fid_buf.data();

  for (int64_t base = 0; base < b->n_points; base += kChunk) {
    const int64_t m = std::min(kChunk, b->n_points - base);
    const uint32_t* rng = ranges_mm + base;
    const float* dxp = b->dx.data() + base;
    const float* dyp = b->dy.data() + base;
    const float* dzp = b->dz.data() + base;
    const float* oxp = b->ox.data() + base;
    const float* oyp = b->oy.data() + base;
    const float* ozp = b->oz.data() + base;
    const uint8_t* mkp = b->mask.data() + base;
    const float* inp = intensity ? intensity + base : nullptr;
    uint8_t* actp = out_active ? out_active + base : nullptr;

    // Raycast-gate loop (vectorizable on its own — the conditional
    // intensity pointer would block if-conversion of the main pass):
    // reference skip rule negated (vofod_nodelet.cpp:1449-1450).
    if (actp) {
      if (inp) {
        for (int64_t j = 0; j < m; ++j)
          // `!(i < min)` not `i >= min`: NaN intensity passes the reference
          // gate (NaN < x is false, vofod_nodelet.cpp:1449)
          actp[j] =
              ((!(inp[j] < min_intensity)) & ((mkp[j] != 0) | (rng[j] > 0)))
                  ? 1
                  : 0;
      } else {
        for (int64_t j = 0; j < m; ++j)
          actp[j] = ((mkp[j] != 0) | (rng[j] > 0)) ? 1 : 0;
      }
    }

    // Pass 1 (branchless, vectorized): voxel id or -1 per point, exclude
    // flag folded into bit 30 (fid < 2^30 by the sharded-path id ceiling).
    // Float semantics mirror the device frontend exactly: mul-then-add (no
    // FMA: -ffp-contract=off), same comparison and floor order.
#pragma omp simd
    for (int64_t j = 0; j < m; ++j) {
      const float r = float(rng[j]) * 0.001f;
      const bool has_return = r > 0.0f;
      const float psx = dxp[j] * r + oxp[j];
      const float psy = dyp[j] * r + oyp[j];
      const float psz = dzp[j] * r + ozp[j];
      const bool excl = (psx >= elx) & (psx <= ehx) & (psy >= ely) &
                        (psy <= ehy) & (psz >= elz) & (psz <= ehz);
      // world transform (row-major R, p @ R.T + t elementwise order)
      const float pwx = psx * r00 + psy * r01 + psz * r02 + tx;
      const float pwy = psx * r10 + psy * r11 + psz * r12 + ty;
      const float pwz = psx * r20 + psy * r21 + psz * r22 + tz;
      const bool inop = (pwx >= plx) & (pwx <= phx) & (pwy >= ply) &
                        (pwy <= phy) & (pwz >= plz) & (pwz <= phz);
      // floor as trunc-and-correct (bit-identical for in-range values;
      // GCC will not vectorize std::floor itself without -ffast-math)
      const float fx = (pwx - gox) * ivx;
      const float fy = (pwy - goy) * ivx;
      const float fz = (pwz - goz) * ivx;
      int32_t ix = int32_t(fx);
      int32_t iy = int32_t(fy);
      int32_t iz = int32_t(fz);
      ix -= (float(ix) > fx) ? 1 : 0;
      iy -= (float(iy) > fy) ? 1 : 0;
      iz -= (float(iz) > fz) ? 1 : 0;
      const bool inb = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) &
                       (iz >= 0) & (iz < nz);
      // clamp before the flat-id multiply: out-of-range indices (discarded
      // via inb anyway) must not trip signed-overflow UB in the select form
      const int32_t cx = std::min(std::max(ix, 0), nx - 1);
      const int32_t cy = std::min(std::max(iy, 0), ny - 1);
      const int32_t cz = std::min(std::max(iz, 0), nz - 1);
      const int32_t fid =
          ((cz * ny + cy) * nx + cx) | (int32_t(excl) << 30);
      // arithmetic select (mask AND/OR) — a bool-driven ternary here makes
      // GCC keep a branch, which kills vectorization of the whole loop
      const int32_t keep = -int32_t(has_return & inop & inb);
      fid_buf[j] = (fid & keep) | ~keep;  // keep ? fid : -1
    }

    // Pass 2 (scalar): saturating scatter into the packed grid.
    for (int64_t j = 0; j < m; ++j) {
      const int32_t tagged = fid_buf[j];
      if (tagged < 0) continue;
      const int32_t fid = tagged & ~(int32_t(1) << 30);
      uint8_t v = out_grid[fid];
      v |= 0x80;  // any return blocks rays (incl. own airframe, :1455)
      if (tagged >> 30) {
        ++n_excl;
      } else {
        ++n_valid;
        if ((v & 0x3f) < 63) ++v;  // saturating 6-bit count
      }
      out_grid[fid] = v;
    }
  }

  if (out_stats) {
    out_stats[0] = n_valid;
    out_stats[1] = n_excl;
  }
}

}  // extern "C"
