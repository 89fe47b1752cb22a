// The last launch of a kernel, kept by its launcher so the caller can read
// back what the launch took without a profiler: the kernel's registers a
// thread and static shared memory a block as the runtime loaded it
// (cudaFuncGetAttributes), and the launch's own dynamic shared memory, grid
// and block.  Each source keeps an array of notes, one slot a kernel, and a
// plain C entry point that reads a slot with read_launch_note.

#pragma once

#include <cuda_runtime.h>

#include <cstdio>

namespace {

struct LaunchNote {
  const void* kernel;   // the launched instantiation (nullptr: none yet)
  const char* name;     // its name, as ptxas's report gives it
  dim3 grid, block;
  size_t smem;          // dynamic shared memory a block
  long long count;      // launches noted in this slot since the library was loaded
};

template <typename Kernel>
void note_launch(LaunchNote& note, Kernel kernel, const char* name, dim3 grid, dim3 block,
                 size_t smem) {
  note.kernel = reinterpret_cast<const void*>(kernel);
  note.name = name;
  note.grid = grid;
  note.block = block;
  note.smem = smem;
  ++note.count;
}

// `out` = {registers, static shared memory, dynamic shared memory, grid x, y,
// z, block x, y, z, launches}; the name into `name` (`len` bytes with the
// closing zero).  Returns a cudaError_t.
int read_launch_note(const LaunchNote& note, long long* out, char* name, int len) {
  if (len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  long long regs = 0, static_smem = 0;
  if (note.kernel != nullptr) {
    cudaFuncAttributes attr;
    const cudaError_t rc = cudaFuncGetAttributes(&attr, note.kernel);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    regs = attr.numRegs;
    static_smem = static_cast<long long>(attr.sharedSizeBytes);
  }
  const long long v[10] = {regs, static_smem, static_cast<long long>(note.smem),
                           note.grid.x, note.grid.y, note.grid.z,
                           note.block.x, note.block.y, note.block.z, note.count};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  std::snprintf(name, len, "%s", note.name != nullptr ? note.name : "");
  return 0;
}

}  // namespace
