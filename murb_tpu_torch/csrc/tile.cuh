// K3's launches (tile.cu), for the kernel that reuses them: K14 (ring.cu)
// sweeps each ring step with K3's register-tiled kernel.
#pragma once

#include <cuda_runtime.h>

namespace murb {

// K3's sweep of ni targets against nj sources on `stream` (csrc/tile.cu,
// murb_tile_rect's arguments): block_i, block_j 0 or a pair of {64, 128,
// 256, 512}; slices, tiles_per_slice the j split (ops/cuda.tile_split),
// scratch (slices, 3, ni) floats when slices > 1.  accumulate != 0 adds
// the sums to ax, ay, az instead of writing them.  Returns the
// cudaError_t of the launches.
int tile_rect_launch(const float* qxi, const float* qyi, const float* qzi,
                     int ni, const float* qxj, const float* qyj,
                     const float* qzj, const float* gmj, int nj, float soft2,
                     int block_i, int block_j, int slices,
                     int tiles_per_slice, float* scratch, int accumulate,
                     float* ax, float* ay, float* az, cudaStream_t stream);

}  // namespace murb
