// Common includes and the C export macro of the kernel library.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define CUTESDR_API extern "C" __attribute__((visibility("default")))

namespace cutesdr {
constexpr unsigned FULL = 0xffffffffu;   // all lanes of a warp
}  // namespace cutesdr
