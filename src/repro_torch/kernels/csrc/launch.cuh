// What every C entry point of the port's kernels shares: the launch
// geometry it is handed and the error string the wrappers read.
//
// The Python wrapper computes each launch's grid, block and dynamic
// shared-memory bytes in plain integers (a `Launch` record in
// kernels/_build.py) and the funnel `_build.launch` passes exactly those
// seven values, last, to the entry point, which launches with them.  So
// the geometry that the static checks (repro_torch.analysis) read from the
// record is the geometry on the card.  An entry point that launches k
// kernels in order takes k geometries, one after another
// (REPRO_GEOMETRY_K).  An entry point may keep its own guards and returns
// cudaErrorInvalidValue where they fail.
#pragma once
#include <cuda_runtime.h>

#define REPRO_GEOMETRY                                                     \
  unsigned grid_x, unsigned grid_y, unsigned grid_z, unsigned block_x,     \
      unsigned block_y, unsigned block_z, unsigned smem
#define REPRO_GRID dim3(grid_x, grid_y, grid_z)
#define REPRO_BLOCK dim3(block_x, block_y, block_z)

// the k-th of several geometries
#define REPRO_GEOMETRY_K(k)                                                \
  unsigned grid_x##k, unsigned grid_y##k, unsigned grid_z##k,              \
      unsigned block_x##k, unsigned block_y##k, unsigned block_z##k,       \
      unsigned smem##k
#define REPRO_GRID_K(k) dim3(grid_x##k, grid_y##k, grid_z##k)
#define REPRO_BLOCK_K(k) dim3(block_x##k, block_y##k, block_z##k)

inline int repro_last_error() { return static_cast<int>(cudaGetLastError()); }

inline int repro_invalid() { return static_cast<int>(cudaErrorInvalidValue); }

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
