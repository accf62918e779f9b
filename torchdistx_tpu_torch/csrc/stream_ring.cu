// The streamed tail of the persistent decode loop: a host function that a
// captured loop iteration runs on its stream (a host node of the CUDA
// graph), recording each iteration into a ring in host memory.
//
// Replaces the JAX package's io_callback / debug.callback streamed tail
// (torchdistx_tpu/generation.py, the persistent loop's stream_cb), which
// calls a Python function on a runtime thread.  Here the host function is
// this C code: it never takes the GIL, so a main thread blocked on the
// stream cannot deadlock against it.
//
// tdx_stream_ring_push enqueues two operations on the stream, which a
// capture records as two graph nodes:
//   1. an async copy of `width` int64 values (the iteration's tokens, its
//      live mask and its cursor, staged on the device) into a pinned
//      staging row;
//   2. cudaLaunchHostFunc(push_row): after the copy has landed, and
//      before any later work on the stream starts, the host function
//      copies the staging row into the next ring row and stamps it with
//      CLOCK_MONOTONIC (the clock of Python's time.monotonic), then
//      publishes the row count with a release store.
// The ring's memory belongs to the caller (torch tensors); `header` holds
// int64 {capacity, width, staging address, rows address, stamps address,
// count, dropped}.  The host reads rows [0, count) after an acquire read of
// count; pushes past capacity are counted in `dropped`, never written.

#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>
#include <time.h>

namespace {

enum { CAPACITY, WIDTH, STAGING, ROWS, STAMPS, COUNT, DROPPED, HEADER_LEN };

void CUDART_CB push_row(void* arg) {
  int64_t* h = static_cast<int64_t*>(arg);
  const int64_t n = __atomic_load_n(&h[COUNT], __ATOMIC_RELAXED);
  if (n >= h[CAPACITY]) {
    __atomic_add_fetch(&h[DROPPED], 1, __ATOMIC_RELAXED);
    return;
  }
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  const int64_t w = h[WIDTH];
  int64_t* rows = reinterpret_cast<int64_t*>(h[ROWS]);
  double* stamps = reinterpret_cast<double*>(h[STAMPS]);
  memcpy(rows + n * w, reinterpret_cast<const int64_t*>(h[STAGING]), w * sizeof(int64_t));
  stamps[n] = static_cast<double>(ts.tv_sec) + 1e-9 * static_cast<double>(ts.tv_nsec);
  __atomic_store_n(&h[COUNT], n + 1, __ATOMIC_RELEASE);
}

}  // namespace

extern "C" int tdx_stream_ring_header_len() { return HEADER_LEN; }

// Enqueue one push of `src` (width int64 values on the device) on `stream`.
// Returns a cudaError_t: a capture that cannot take the copy or the host
// node fails here, and the caller raises.
extern "C" int tdx_stream_ring_push(void* header, const void* src, void* stream) {
  int64_t* h = static_cast<int64_t*>(header);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(reinterpret_cast<void*>(h[STAGING]), src,
                                    h[WIDTH] * sizeof(int64_t), cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaLaunchHostFunc(s, push_row, header);
}

// The row count with acquire semantics (rows below it are complete).
extern "C" int64_t tdx_stream_ring_count(const void* header) {
  return __atomic_load_n(&static_cast<const int64_t*>(header)[COUNT], __ATOMIC_ACQUIRE);
}
