// Asynchronous host file IO: the NVMe tier of the serving engine's host
// KV cache (and of the optimizer offload to come).
//
// Copy of ``deepspeed_tpu/ops/csrc/aio.cpp`` for the PyTorch port, built
// with g++ by ``ops/build.py`` (``HOST_LIBS``) and loaded with ctypes:
//   - a std::thread pool issues pread/pwrite directly (no libaio);
//   - files are opened O_DIRECT when the (buffer, offset, length) triple is
//     4096-aligned (the Python side allocates aligned buffers and pads the
//     file's slots), and a filesystem that refuses O_DIRECT (EINVAL) gets
//     the whole chunk again through buffered IO;
//   - an op larger than block_size is split across the pool so a single
//     large transfer overlaps its own chunks.
// ``ds_aio_odirect_fallbacks`` counts the chunks that fell back to
// buffered IO, so a caller can tell whether O_DIRECT held.
//
// Exposed as a plain C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr int64_t kAlign = 4096;

// chunks that opened O_DIRECT-eligible but ran buffered (open refused the
// flag, or a read/write under it returned EINVAL)
std::atomic<int64_t> g_odirect_fallbacks{0};

struct IoChunk {
    struct IoOp* op;
    char* buf;
    int64_t nbytes;
    int64_t file_offset;
};

struct IoOp {
    std::string path;
    bool is_read;
    bool do_fsync;
    std::atomic<int> chunks_left{0};
    std::atomic<int> failed{0};   // errno of first failure, else 0
    int64_t id;
    bool aligned;                 // O_DIRECT eligible
};

struct AioHandle {
    std::vector<std::thread> threads;
    std::deque<IoChunk> queue;
    std::mutex mu;
    std::condition_variable cv_work;   // workers wait for chunks
    std::condition_variable cv_done;   // waiters wait for op completion
    std::vector<std::unique_ptr<IoOp>> inflight;  // completed ops pruned on wait
    bool stop = false;
    int64_t next_id = 0;
    int64_t block_size;
    bool use_odirect;
    int first_error = 0;   // sticky errno across waits

    explicit AioHandle(int num_threads, int64_t blk, bool odirect)
        : block_size(blk), use_odirect(odirect) {
        for (int i = 0; i < num_threads; ++i)
            threads.emplace_back([this] { worker(); });
    }

    ~AioHandle() {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop = true;
        }
        cv_work.notify_all();
        for (auto& t : threads) t.join();
    }

    void run_chunk(const IoChunk& c) {
        IoOp* op = c.op;
        int flags = op->is_read ? O_RDONLY : (O_WRONLY | O_CREAT);
        bool odirect = use_odirect && op->aligned;
        int fd = -1;
        if (odirect) fd = open(op->path.c_str(), flags | O_DIRECT, 0644);
        if (odirect && fd < 0) {
            g_odirect_fallbacks.fetch_add(1);
            odirect = false;
        }
        if (fd < 0) fd = open(op->path.c_str(), flags, 0644);
        int err = 0;
        if (fd < 0) {
            err = errno ? errno : EIO;
        } else {
            int64_t done = 0;
            while (done < c.nbytes) {
                ssize_t r = op->is_read
                    ? pread(fd, c.buf + done, c.nbytes - done,
                            c.file_offset + done)
                    : pwrite(fd, c.buf + done, c.nbytes - done,
                             c.file_offset + done);
                if (r < 0) {
                    if (errno == EINVAL && odirect) {
                        // O_DIRECT rejected mid-stream (fs quirk): retry
                        // the whole chunk buffered.
                        close(fd);
                        fd = open(op->path.c_str(), flags, 0644);
                        odirect = false;
                        g_odirect_fallbacks.fetch_add(1);
                        if (fd < 0) { err = errno ? errno : EIO; break; }
                        done = 0;
                        continue;
                    }
                    err = errno ? errno : EIO;
                    break;
                }
                if (r == 0 && op->is_read) { err = EIO; break; }  // short file
                done += r;
            }
            if (!err && op->do_fsync && !op->is_read) {
                if (fsync(fd) != 0) err = errno ? errno : EIO;
            }
            close(fd);
        }
        if (err) {
            int expected = 0;
            op->failed.compare_exchange_strong(expected, err);
        }
        if (op->chunks_left.fetch_sub(1) == 1) {
            std::lock_guard<std::mutex> lk(mu);
            cv_done.notify_all();
        }
    }

    void worker() {
        for (;;) {
            IoChunk c;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_work.wait(lk, [this] { return stop || !queue.empty(); });
                if (stop && queue.empty()) return;
                c = queue.front();
                queue.pop_front();
            }
            run_chunk(c);
        }
    }

    int64_t submit(char* buf, int64_t nbytes, const char* path,
                   int64_t file_offset, bool is_read, bool do_fsync) {
        auto op = std::make_unique<IoOp>();
        op->path = path;
        op->is_read = is_read;
        op->do_fsync = do_fsync;
        op->aligned = (reinterpret_cast<uintptr_t>(buf) % kAlign == 0) &&
                      (nbytes % kAlign == 0) && (file_offset % kAlign == 0);
        int n_chunks = 1;
        if (nbytes > block_size) {
            n_chunks = (int)((nbytes + block_size - 1) / block_size);
            int cap = (int)threads.size() * 2;
            if (n_chunks > cap) n_chunks = cap > 0 ? cap : 1;
        }
        // chunk boundaries stay kAlign-multiples so O_DIRECT holds per chunk
        int64_t chunk = ((nbytes / n_chunks + kAlign - 1) / kAlign) * kAlign;
        if (chunk <= 0) chunk = nbytes;
        std::vector<IoChunk> chunks;
        for (int64_t off = 0; off < nbytes; off += chunk) {
            int64_t len = std::min(chunk, nbytes - off);
            chunks.push_back(IoChunk{op.get(), buf + off, len,
                                     file_offset + off});
        }
        op->chunks_left.store((int)chunks.size());
        int64_t id;
        {
            std::lock_guard<std::mutex> lk(mu);
            id = next_id++;
            op->id = id;
            inflight.push_back(std::move(op));
            for (auto& c : chunks) queue.push_back(c);
        }
        cv_work.notify_all();
        return id;
    }

    // wait for every submitted op; return -errno of the first failure (0 ok)
    int wait_all() {
        std::unique_lock<std::mutex> lk(mu);
        cv_done.wait(lk, [this] {
            for (auto& op : inflight)
                if (op->chunks_left.load() > 0) return false;
            return true;
        });
        for (auto& op : inflight)
            if (op->failed.load() && !first_error)
                first_error = op->failed.load();
        inflight.clear();
        int e = first_error;
        first_error = 0;
        return e ? -e : 0;
    }

    int wait_op(int64_t id) {
        std::unique_lock<std::mutex> lk(mu);
        IoOp* target = nullptr;
        for (auto& op : inflight)
            if (op->id == id) { target = op.get(); break; }
        if (!target) return 0;   // already pruned by a wait_all
        cv_done.wait(lk, [target] { return target->chunks_left.load() == 0; });
        int e = target->failed.load();  // reported here, not re-reported by
                                        // a later wait_all
        for (auto it = inflight.begin(); it != inflight.end(); ++it)
            if (it->get() == target) { inflight.erase(it); break; }
        return e ? -e : 0;
    }

    int pending() {
        std::lock_guard<std::mutex> lk(mu);
        int n = 0;
        for (auto& op : inflight)
            if (op->chunks_left.load() > 0) ++n;
        return n;
    }
};

}  // namespace

extern "C" {

void* ds_aio_new(int num_threads, int64_t block_size, int use_odirect) {
    if (num_threads < 1) num_threads = 1;
    if (block_size < kAlign) block_size = 1 << 20;
    return new AioHandle(num_threads, block_size, use_odirect != 0);
}

void ds_aio_destroy(void* h) { delete static_cast<AioHandle*>(h); }

int64_t ds_aio_pread(void* h, void* buf, int64_t nbytes, const char* path,
                     int64_t file_offset) {
    return static_cast<AioHandle*>(h)->submit(
        static_cast<char*>(buf), nbytes, path, file_offset, true, false);
}

int64_t ds_aio_pwrite(void* h, const void* buf, int64_t nbytes,
                      const char* path, int64_t file_offset, int do_fsync) {
    return static_cast<AioHandle*>(h)->submit(
        const_cast<char*>(static_cast<const char*>(buf)), nbytes, path,
        file_offset, false, do_fsync != 0);
}

int ds_aio_wait(void* h) { return static_cast<AioHandle*>(h)->wait_all(); }

int ds_aio_wait_op(void* h, int64_t op) {
    return static_cast<AioHandle*>(h)->wait_op(op);
}

int ds_aio_pending(void* h) { return static_cast<AioHandle*>(h)->pending(); }

void* ds_aio_alloc_pinned(int64_t nbytes) {
    void* p = nullptr;
    if (posix_memalign(&p, kAlign, (size_t)nbytes) != 0) return nullptr;
    std::memset(p, 0, (size_t)nbytes);
    return p;
}

void ds_aio_free_pinned(void* p) { free(p); }

int64_t ds_aio_odirect_fallbacks() { return g_odirect_fallbacks.load(); }

}  // extern "C"
