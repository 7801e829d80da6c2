// murb_tpu_torch native runtime components (the port's own copy of
// murb_tpu's native/murbnative.cpp; same C ABI, same formats).
//
// The reference implements its whole runtime in C++ (state container, file
// IO, timers -- src/common/core/Bodies.cpp, src/common/utils/Perf.cpp).  In
// the port the compute path is PyTorch and the CUDA kernels of csrc/; these
// are the host-side runtime pieces where native code still earns its keep:
//
//   * murb_count_tab / murb_parse_tab -- fast two-pass whitespace table
//     parser for initial-condition files (the data-loader analogue of
//     Bodies::initMilkyWayAndromeda's ifstream loop, ref: Bodies.cpp:91-150;
//     strtod-based).
//   * murb_write_history_csv -- metrics CSV writer with the reference's
//     exact column schema (ref: SimulationHistory.cpp:104-122).
//   * trajectory dump writer -- a bounded-queue background-thread binary
//     frame writer so trajectory export never stalls the simulation loop
//     (the reference stalls: its visu path reads sim arrays synchronously
//     each frame, ref: main.cpp:350).
//   * murb_now_us -- microsecond wall clock (Perf parity, ref: Perf.cpp).
//
// Exposed as a plain C ABI consumed via ctypes (murb_tpu_torch/native.py,
// which builds it with g++ at first use); every entry point has a
// pure-python fallback, so the package works without a compiler.
#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <sys/time.h>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- time
double murb_now_us() {
    struct timeval tv;
    gettimeofday(&tv, nullptr);
    return (double)tv.tv_sec * 1e6 + (double)tv.tv_usec;
}

// ---------------------------------------------------------------- tab IO
// Count non-empty lines (pass 1 of the loader).
long murb_count_tab(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    long rows = 0;
    bool line_has_content = false;
    char buf[1 << 16];
    size_t got;
    while ((got = fread(buf, 1, sizeof(buf), f)) > 0) {
        for (size_t i = 0; i < got; i++) {
            char c = buf[i];
            if (c == '\n') {
                if (line_has_content) rows++;
                line_has_content = false;
            } else if (c != ' ' && c != '\t' && c != '\r') {
                line_has_content = true;
            }
        }
    }
    if (line_has_content) rows++;
    fclose(f);
    return rows;
}

// Parse up to max_rows rows of `cols` whitespace-separated doubles into
// `out` (row-major).  Returns rows parsed, or -1 on IO error, -2 on a
// malformed row (fewer than `cols` values).
long murb_parse_tab(const char* path, double* out, long max_rows, int cols) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    // Read whole file (IC files are at most a few hundred MB).
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> data((size_t)size + 1);
    if (fread(data.data(), 1, (size_t)size, f) != (size_t)size) {
        fclose(f);
        return -1;
    }
    fclose(f);
    data[(size_t)size] = '\0';

    char* p = data.data();
    char* end = p + size;
    long row = 0;
    while (p < end && row < max_rows) {
        // skip blank lines
        while (p < end && (*p == '\n' || *p == '\r')) p++;
        if (p >= end) break;
        char* line_end = (char*)memchr(p, '\n', (size_t)(end - p));
        if (!line_end) line_end = end;
        // check the line has content
        char* q = p;
        bool content = false;
        for (char* c = p; c < line_end; c++) {
            if (*c != ' ' && *c != '\t' && *c != '\r') { content = true; break; }
        }
        if (content) {
            int col = 0;
            for (; col < cols; col++) {
                errno = 0;
                char* next = nullptr;
                double v = strtod(q, &next);
                if (next == q || next > line_end) break;
                out[row * cols + col] = v;
                q = next;
            }
            if (col != cols) return -2 - row;  // encodes the offending row
            row++;
        }
        p = line_end + 1;
    }
    return row;
}

// ---------------------------------------------------------------- CSV
// Exact column schema of the reference exporter
// (iteration,energy,ang_momentum,density_center_x,_y,_z).
int murb_write_history_csv(const char* path, long n, const double* energies,
                           const double* ang, const double* dcx,
                           const double* dcy, const double* dcz) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    fputs("iteration,energy,ang_momentum,density_center_x,"
          "density_center_y,density_center_z\n", f);
    for (long i = 0; i < n; i++) {
        fprintf(f, "%ld,%.17g,%.17g,%.17g,%.17g,%.17g\n", i, energies[i],
                ang[i], dcx[i], dcy[i], dcz[i]);
    }
    fclose(f);
    return 0;
}

// ------------------------------------------------------- trajectory dump
// Binary format: header "MURBTRAJ" u32 version u64 n_bodies, then frames of
// u64 index + 3*n float32 (qx block, qy block, qz block).
struct TrajWriter {
    FILE* f = nullptr;
    uint64_t n = 0;
    std::thread worker;
    std::mutex mu;
    std::condition_variable cv;
    std::queue<std::pair<uint64_t, std::vector<float>>> queue;
    std::atomic<bool> stop{false};
    std::atomic<long> dropped{0};
    size_t max_queue = 8;

    void run() {
        for (;;) {
            std::pair<uint64_t, std::vector<float>> item;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv.wait(lk, [&] { return stop.load() || !queue.empty(); });
                if (queue.empty()) {
                    if (stop.load()) return;
                    continue;
                }
                item = std::move(queue.front());
                queue.pop();
            }
            fwrite(&item.first, sizeof(uint64_t), 1, f);
            fwrite(item.second.data(), sizeof(float), item.second.size(), f);
        }
    }
};

void* murb_traj_open(const char* path, uint64_t n_bodies) {
    FILE* f = fopen(path, "wb");
    if (!f) return nullptr;
    auto* w = new TrajWriter();
    w->f = f;
    w->n = n_bodies;
    fwrite("MURBTRAJ", 1, 8, f);
    uint32_t version = 1;
    fwrite(&version, sizeof(uint32_t), 1, f);
    fwrite(&n_bodies, sizeof(uint64_t), 1, f);
    w->worker = std::thread([w] { w->run(); });
    return w;
}

// Non-blocking append: copies the frame into the writer queue.  If the disk
// can't keep up (queue full) the frame is DROPPED and counted -- the
// simulation loop never stalls.
int murb_traj_append(void* handle, uint64_t frame_index, const float* qx,
                     const float* qy, const float* qz) {
    auto* w = (TrajWriter*)handle;
    std::vector<float> buf(3 * w->n);
    memcpy(buf.data(), qx, w->n * sizeof(float));
    memcpy(buf.data() + w->n, qy, w->n * sizeof(float));
    memcpy(buf.data() + 2 * w->n, qz, w->n * sizeof(float));
    {
        std::lock_guard<std::mutex> lk(w->mu);
        if (w->queue.size() >= w->max_queue) {
            w->dropped++;
            return 1;  // dropped
        }
        w->queue.emplace(frame_index, std::move(buf));
    }
    w->cv.notify_one();
    return 0;
}

long murb_traj_close(void* handle) {
    auto* w = (TrajWriter*)handle;
    {
        std::lock_guard<std::mutex> lk(w->mu);
        w->stop = true;
    }
    w->cv.notify_one();
    w->worker.join();
    // drain anything left (stop raced with producer)
    while (!w->queue.empty()) {
        auto& item = w->queue.front();
        fwrite(&item.first, sizeof(uint64_t), 1, w->f);
        fwrite(item.second.data(), sizeof(float), item.second.size(), w->f);
        w->queue.pop();
    }
    fclose(w->f);
    long dropped = w->dropped.load();
    delete w;
    return dropped;
}

}  // extern "C"
