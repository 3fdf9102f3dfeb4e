// Per-device set-up of the kernel library's launchers.
//
// cudaFuncSetAttribute acts on the current device only, and a <<<>>> launch
// goes to the current device, so what a launcher sets up once for a kernel
// function (the dynamic shared-memory opt-in above 48 KB, the count of
// resident blocks) it sets up once on each device it launches on.  A
// launcher keeps one PerDevice table a value as a function static; entry d
// is filled at the first launch on device d.  Two threads that fill an
// entry at once both compute the same value.

#pragma once

#include <atomic>

#include <cuda_runtime.h>

constexpr int MAX_DEVICES = 64;

struct PerDevice {
  std::atomic<int> slot[MAX_DEVICES];  // 0: not set up yet; else the value + 1
};

// The current device's ordinal; -1 if it cannot be read or the tables do
// not reach it.
inline int current_device() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return -1;
  return dev;
}

// make()'s value on device dev, computed at the first call for that device.
template <typename Make>
int once_per_device(PerDevice& table, int dev, Make make) {
  int v = table.slot[dev].load(std::memory_order_acquire);
  if (v == 0) {
    v = make() + 1;
    table.slot[dev].store(v, std::memory_order_release);
  }
  return v - 1;
}
