// Native scene-composition kernel: distance-priority pasting of retrieved
// patch crops into full-scene volumes.
//
// Host-side hot loop of the offline compose stage (the reference runs this
// paste loop in torch-on-CPU per scene, util/retrieval.py:145-164; ours in
// numpy). One call pastes all P patch instructions for one (scene, k) pair:
// python gathers the source crops into a dense (P, ps³) buffer, this kernel
// applies the running-distance priority rule.

#include <cstdint>

extern "C" {

// volume, distances: (X, Y, Z) C-order float buffers (mutated in place).
// crops: (P, ps*ps*ps) source crops, already trunc-ratio scaled.
// extents: (P, 6) int32 dest boxes [x0,x1,y0,y1,z0,z1] (x1-x0 == ps etc).
// dists: (P,) float distance per paste.
// no_overlap: skip the region-mean check (stride == patch size).
void compose_paste(float *volume, float *distances,
                   int64_t X, int64_t Y, int64_t Z,
                   const float *crops, const int32_t *extents, const float *dists,
                   int64_t P, int64_t ps, int no_overlap) {
  const int64_t sy = Z;
  const int64_t sx = Y * Z;
  const int64_t cell = ps * ps * ps;
  for (int64_t p = 0; p < P; ++p) {
    const int32_t x0 = extents[p * 6 + 0], y0 = extents[p * 6 + 2], z0 = extents[p * 6 + 4];
    const float d = dists[p];
    if (!no_overlap) {
      // region mean of the running distance volume must exceed d
      double sum = 0.0;
      for (int64_t i = 0; i < ps; ++i)
        for (int64_t j = 0; j < ps; ++j) {
          const float *row = distances + (x0 + i) * sx + (y0 + j) * sy + z0;
          for (int64_t k = 0; k < ps; ++k) sum += row[k];
        }
      if (!(sum / static_cast<double>(cell) > d)) continue;
    }
    const float *src = crops + p * cell;
    for (int64_t i = 0; i < ps; ++i)
      for (int64_t j = 0; j < ps; ++j) {
        float *vrow = volume + (x0 + i) * sx + (y0 + j) * sy + z0;
        float *drow = distances + (x0 + i) * sx + (y0 + j) * sy + z0;
        const float *srow = src + (i * ps + j) * ps;
        for (int64_t k = 0; k < ps; ++k) {
          vrow[k] = srow[k];
          drow[k] = d;
        }
      }
  }
}

}  // extern "C"
