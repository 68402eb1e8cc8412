// Host stand-in of cooperative_groups.h: a grid barrier is a std::barrier
// over every thread of the launch.
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct grid_group { void sync() { si_grid->bar.arrive_and_wait(); } };
inline grid_group this_grid() { return {}; }
}
