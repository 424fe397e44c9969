// The launch floor: an empty kernel, launched with the grid and block a
// kernel uses, takes the least time any launch of that shape can take on
// the card (the launch itself and one wave of empty blocks). chip_smoke.py
// times it beside each kernel (`floor_ms`), at the grid and block that
// kernel's sources report (`lane_group_geometry` here for the lane-group
// kernels, `cov_flush_geometry` beside the flush's launcher); it is not a
// kernel of any path.

#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

// The grid and block of the lane-group kernels (step_megakernel,
// pop_gather, pop_earliest) at `lanes` lanes.
extern "C" void lane_group_geometry(int lanes, int* grid, int* block) {
  *grid = static_cast<int>(madsim::group_grid(lanes).x);
  *block = madsim::GROUP_BLOCK;
}

extern "C" int launch_floor_launch(int grid, int block, void* stream) {
  if (grid < 0 || block < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (grid == 0) return 0;
  empty_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
