// ns3dio: native I/O runtime for navierstokes3d_tpu.
//
// The reference's I/O runs through native libraries (MAT.jl -> HDF5-family
// C code, Plots/GR -> C plotting) and blocks the simulation loop while
// writing (save_array, NavierStokes3D_multi_gpu.jl:27-30). This module is
// this framework's counterpart: a small C++ runtime that
//   * converts row-major (C-order) field blocks to the on-disk
//     column-major (Julia/Fortran order) .bin layout with a cache-blocked
//     transpose, and
//   * performs writes on a background thread pool with a bounded job
//     queue, so frame dumps overlap with device compute instead of
//     stalling the step loop.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Job {
  std::string path;
  std::vector<float> data;  // already in on-disk order
};

class AsyncWriter {
 public:
  static AsyncWriter& instance() {
    // Intentionally leaked: destroying the mutex/condvars at static
    // destruction while the detached worker waits on them is UB and
    // hangs process exit.
    static AsyncWriter* w = new AsyncWriter();
    return *w;
  }

  void submit(std::string path, std::vector<float> data) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      // Bounded queue: apply backpressure rather than exhausting memory.
      not_full_.wait(lk, [&] { return jobs_.size() < kMaxQueue; });
      jobs_.push_back(Job{std::move(path), std::move(data)});
      ++pending_;
    }
    not_empty_.notify_one();
    ensure_worker();
  }

  // Block until all submitted jobs have been written.
  void drain() {
    std::unique_lock<std::mutex> lk(mu_);
    drained_.wait(lk, [&] { return pending_ == 0; });
  }

  int64_t pending() {
    std::lock_guard<std::mutex> lk(mu_);
    return pending_;
  }

 private:
  static constexpr size_t kMaxQueue = 16;

  void ensure_worker() {
    std::call_once(started_, [&] {
      worker_ = std::thread([this] { run(); });
      worker_.detach();
    });
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        not_empty_.wait(lk, [&] { return !jobs_.empty(); });
        job = std::move(jobs_.front());
        jobs_.pop_front();
      }
      not_full_.notify_one();
      write_file(job);
      {
        std::lock_guard<std::mutex> lk(mu_);
        --pending_;
      }
      drained_.notify_all();
    }
  }

  static void write_file(const Job& job) {
    FILE* f = std::fopen(job.path.c_str(), "wb");
    if (!f) return;
    std::fwrite(job.data.data(), sizeof(float), job.data.size(), f);
    std::fclose(f);
  }

  std::mutex mu_;
  std::condition_variable not_empty_, not_full_, drained_;
  std::deque<Job> jobs_;
  int64_t pending_ = 0;
  std::once_flag started_;
  std::thread worker_;
};

// Cache-blocked C-order (n1,n2,n3) -> Fortran-order flatten.
// dst[i + j*n1 + k*n1*n2] = src[i*n2*n3 + j*n3 + k]
void transpose_f_order(const float* src, float* dst, int64_t n1, int64_t n2,
                       int64_t n3) {
  constexpr int64_t kB = 64;
  for (int64_t i0 = 0; i0 < n1; i0 += kB) {
    const int64_t i1 = std::min(i0 + kB, n1);
    for (int64_t k0 = 0; k0 < n3; k0 += kB) {
      const int64_t k1 = std::min(k0 + kB, n3);
      for (int64_t j = 0; j < n2; ++j) {
        for (int64_t i = i0; i < i1; ++i) {
          const float* s = src + (i * n2 + j) * n3;
          float* d = dst + i + j * n1;
          for (int64_t k = k0; k < k1; ++k) {
            d[k * n1 * n2] = s[k];
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Synchronous write of a C-order (n1,n2,n3) float32 block in Fortran order.
int ns3dio_write_f32(const char* path, const float* data, int64_t n1,
                     int64_t n2, int64_t n3) {
  std::vector<float> buf(static_cast<size_t>(n1) * n2 * n3);
  transpose_f_order(data, buf.data(), n1, n2, n3);
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const size_t n = std::fwrite(buf.data(), sizeof(float), buf.size(), f);
  std::fclose(f);
  return n == buf.size() ? 0 : -1;
}

// Asynchronous variant: copies + transposes on the calling thread (cheap,
// memory-bandwidth bound), queues the disk write on the background thread.
int ns3dio_write_f32_async(const char* path, const float* data, int64_t n1,
                           int64_t n2, int64_t n3) {
  std::vector<float> buf(static_cast<size_t>(n1) * n2 * n3);
  transpose_f_order(data, buf.data(), n1, n2, n3);
  AsyncWriter::instance().submit(path, std::move(buf));
  return 0;
}

// Block until every queued async write has hit the filesystem.
void ns3dio_drain() { AsyncWriter::instance().drain(); }

int64_t ns3dio_pending() { return AsyncWriter::instance().pending(); }

// Read a Fortran-order .bin back into a C-order (n1,n2,n3) block.
int ns3dio_read_f32(const char* path, float* out, int64_t n1, int64_t n2,
                    int64_t n3) {
  const size_t n = static_cast<size_t>(n1) * n2 * n3;
  std::vector<float> buf(n);
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  const size_t got = std::fread(buf.data(), sizeof(float), n, f);
  std::fclose(f);
  if (got != n) return -1;
  // inverse transpose: out[i,j,k](C) = buf[i + j*n1 + k*n1*n2]
  for (int64_t k = 0; k < n3; ++k)
    for (int64_t j = 0; j < n2; ++j)
      for (int64_t i = 0; i < n1; ++i)
        out[(i * n2 + j) * n3 + k] = buf[i + j * n1 + k * n1 * n2];
  return 0;
}

}  // extern "C"
