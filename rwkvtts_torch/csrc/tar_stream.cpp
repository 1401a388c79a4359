// Native tar shard streamer with background prefetch.
//
// The training input path reads webdataset-style tar shards (wav + json
// members). A C++ reader thread parses ustar headers and fills a bounded
// queue, so shard IO and header parsing overlap the training step instead
// of stalling it.
//
// Format support: POSIX ustar (name + prefix fields), GNU long-name ('L')
// records, PAX 'path' records, octal and base-256 sizes. Regular files
// only. A shard that fails to read is retried twice, skipping the members
// already delivered, so no member is delivered twice; a shard that still
// fails is abandoned, and an "abandoned" record for it enters the queue
// right after its last delivered member, so the consumer knows where the
// shard ended and can drop the sample it cut.
//
// C ABI (ctypes; see rwkvtts_torch/utils/native.py::NativeTarStream):
//   void*   ts_open(const char* paths_blob, int64_t blob_len, int32_t cap)
//             paths_blob: '\n'-joined shard paths; cap: queue capacity
//   int32_t ts_next(void* h, char* name_out, int32_t name_cap,
//                   uint8_t** data_out, int64_t* len_out, int32_t* shard_out)
//             1 = member delivered (free data with ts_free)
//             2 = shard *shard_out abandoned after its delivered members;
//                 name_out: the member whose data was cut, or "" (a cut
//                 elsewhere: a header, padding, an unreadable file)
//             0 = end of all shards
//   int64_t ts_errors(void* h)   // shards abandoned
//   void    ts_free(uint8_t* p)
//   void    ts_close(void* h)
//
// Host C++, not a GPU kernel: rwkvtts_torch/utils/native.py builds it at
// first use with
//   g++ -O3 -shared -fPIC -std=c++17 -pthread -o libtar_stream_<hash>.so tar_stream.cpp

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Member {
  std::string name;
  uint8_t* data = nullptr;  // malloc'd; ownership passes to the consumer
  int64_t len = 0;
  int32_t shard = 0;  // index of the source shard (sample-grouping key)
  bool abandoned = false;  // no member: shard `shard` was abandoned here
};

int64_t parse_size(const unsigned char* f, int n) {
  if (f[0] & 0x80) {  // GNU base-256
    int64_t v = f[0] & 0x7f;
    for (int i = 1; i < n; ++i) v = (v << 8) | f[i];
    return v;
  }
  int64_t v = 0;
  for (int i = 0; i < n && f[i]; ++i) {
    if (f[i] < '0' || f[i] > '7') continue;
    v = v * 8 + (f[i] - '0');
  }
  return v;
}

struct Stream {
  std::vector<std::string> paths;
  std::deque<Member> queue;
  size_t cap;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::atomic<bool> done{false}, closed{false};
  std::atomic<int64_t> errors{0};
  std::thread reader;

  void push(Member&& m) {
    std::unique_lock<std::mutex> lk(mu);
    cv_push.wait(lk, [&] { return queue.size() < cap || closed.load(); });
    if (closed.load()) {
      free(m.data);
      return;
    }
    queue.push_back(std::move(m));
    cv_pop.notify_one();
  }

  // returns false at end-of-stream
  bool pop(Member& out) {
    std::unique_lock<std::mutex> lk(mu);
    cv_pop.wait(lk, [&] { return !queue.empty() || done.load(); });
    if (queue.empty()) return false;
    out = std::move(queue.front());
    queue.pop_front();
    cv_push.notify_one();
    return true;
  }

  // Reads one shard, pushing regular members. `skip` members are consumed
  // without pushing (retry support). Returns true on clean end-of-archive;
  // on a failure, *cut_name is the member whose data was cut (empty when
  // the cut is elsewhere: a header, padding, an unreadable file).
  bool read_shard(const std::string& path, int32_t shard_idx,
                  int64_t skip, int64_t* emitted, std::string* cut_name) {
    cut_name->clear();
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) return false;
    fseek(f, 0, SEEK_END);
    const int64_t file_size = ftell(f);
    fseek(f, 0, SEEK_SET);
    // skip n bytes that must lie inside the file (seeking past the end
    // succeeds: tarfile's rule, a member's padded data ends in the file)
    auto skip_bytes = [&](int64_t n) {
      return ftell(f) + n <= file_size && fseek(f, static_cast<long>(n), SEEK_CUR) == 0;
    };
    bool ok = true;
    unsigned char hdr[512];
    std::string longname;
    int zero_blocks = 0;
    while (!closed.load()) {
      size_t got = fread(hdr, 1, 512, f);
      if (got != 512) {
        // a partial header is a cut, unless an end-of-archive block came first
        if (got != 0 && zero_blocks == 0) ok = false;
        break;
      }
      bool all_zero = true;
      for (int i = 0; i < 512; ++i)
        if (hdr[i]) { all_zero = false; break; }
      if (all_zero) {
        if (++zero_blocks >= 2) break;  // end-of-archive marker
        continue;
      }
      zero_blocks = 0;
      int64_t size = parse_size(hdr + 124, 12);
      if (size < 0 || size > (int64_t{1} << 40)) {  // corrupt header
        ok = false;
        break;
      }
      char type = static_cast<char>(hdr[156]);
      int64_t padded = (size + 511) & ~int64_t{511};

      if (type == 'L') {  // GNU long name: payload is the next member's name
        std::vector<char> buf(static_cast<size_t>(padded));
        if (fread(buf.data(), 1, static_cast<size_t>(padded), f) !=
            static_cast<size_t>(padded)) {
          ok = false;
          break;
        }
        longname.assign(buf.data(), strnlen(buf.data(), static_cast<size_t>(size)));
        continue;
      }

      if (type == 'x' || type == 'g') {
        // PAX extended header (Python tarfile's default format): records
        // are "<len> key=value\n"; a 'path' key overrides the next
        // member's (possibly truncated) ustar name
        std::vector<char> buf(static_cast<size_t>(padded));
        if (fread(buf.data(), 1, static_cast<size_t>(padded), f) !=
            static_cast<size_t>(padded)) {
          ok = false;
          break;
        }
        if (type == 'x') {
          std::string rec(buf.data(), static_cast<size_t>(size));
          size_t pos = 0;
          while (pos < rec.size()) {
            size_t sp = rec.find(' ', pos);
            if (sp == std::string::npos) break;
            long rec_len = strtol(rec.c_str() + pos, nullptr, 10);
            if (rec_len <= 0 ||
                pos + static_cast<size_t>(rec_len) > rec.size() + 1) break;
            std::string kv = rec.substr(sp + 1, pos + rec_len - sp - 2);
            if (kv.rfind("path=", 0) == 0) longname = kv.substr(5);
            pos += static_cast<size_t>(rec_len);
          }
        }
        continue;
      }

      std::string name;
      if (!longname.empty()) {
        name.swap(longname);
      } else {
        char nbuf[101], pbuf[156];
        memcpy(nbuf, hdr, 100);
        nbuf[100] = 0;
        memcpy(pbuf, hdr + 345, 155);
        pbuf[155] = 0;
        name = pbuf[0] ? std::string(pbuf) + "/" + nbuf : std::string(nbuf);
      }

      bool regular = (type == '0' || type == 0 || type == '\0');
      if (!regular) {
        if (!skip_bytes(padded)) {
          ok = false;
          break;
        }
        continue;
      }
      if (*emitted < skip) {  // retry pass: member already delivered
        if (!skip_bytes(padded)) {
          ok = false;
          break;
        }
        ++*emitted;
        continue;
      }
      Member m;
      m.name = std::move(name);
      m.shard = shard_idx;
      m.len = size;
      m.data = static_cast<uint8_t*>(malloc(size ? static_cast<size_t>(size) : 1));
      if (fread(m.data, 1, static_cast<size_t>(size), f) !=
          static_cast<size_t>(size)) {
        free(m.data);
        *cut_name = m.name;
        ok = false;
        break;
      }
      // delivered once its data is whole, as tarfile does; a cut in its
      // padding then cuts the shard
      push(std::move(m));
      ++*emitted;
      if (!skip_bytes(padded - size)) {
        ok = false;
        break;
      }
    }
    fclose(f);
    return ok;
  }

  void run() {
    const int kRetries = 2;  // the stdlib path's retry count (data/webdataset.py)
    for (size_t i = 0; i < paths.size(); ++i) {
      if (closed.load()) break;
      int64_t emitted = 0;
      bool ok = false;
      std::string cut_name;
      for (int attempt = 0; attempt <= kRetries && !closed.load(); ++attempt) {
        int64_t e = 0;
        ok = read_shard(paths[i], static_cast<int32_t>(i), emitted, &e, &cut_name);
        emitted = e > emitted ? e : emitted;
        if (ok) break;
      }
      if (!ok) {
        errors.fetch_add(1);
        Member m;
        m.shard = static_cast<int32_t>(i);
        m.abandoned = true;
        m.name = cut_name;
        push(std::move(m));
      }
    }
    done.store(true);
    cv_pop.notify_all();
  }
};

}  // namespace

extern "C" {

void* ts_open(const char* paths_blob, int64_t blob_len, int32_t cap) {
  auto* s = new Stream();
  s->cap = cap > 0 ? static_cast<size_t>(cap) : 64;
  std::string all(paths_blob, static_cast<size_t>(blob_len));
  size_t start = 0;
  while (start < all.size()) {
    size_t end = all.find('\n', start);
    if (end == std::string::npos) end = all.size();
    if (end > start) s->paths.emplace_back(all.substr(start, end - start));
    start = end + 1;
  }
  s->reader = std::thread([s] { s->run(); });
  return s;
}

int32_t ts_next(void* h, char* name_out, int32_t name_cap, uint8_t** data_out,
                int64_t* len_out, int32_t* shard_out) {
  auto* s = static_cast<Stream*>(h);
  Member m;
  if (!s->pop(m)) return 0;
  *shard_out = m.shard;
  snprintf(name_out, static_cast<size_t>(name_cap), "%s", m.name.c_str());
  if (m.abandoned) return 2;
  *data_out = m.data;  // consumer frees with ts_free
  *len_out = m.len;
  return 1;
}

int64_t ts_errors(void* h) { return static_cast<Stream*>(h)->errors.load(); }

void ts_free(uint8_t* p) { free(p); }

void ts_close(void* h) {
  auto* s = static_cast<Stream*>(h);
  s->closed.store(true);
  s->cv_push.notify_all();
  s->cv_pop.notify_all();
  if (s->reader.joinable()) s->reader.join();
  for (auto& m : s->queue) free(m.data);
  delete s;
}

}  // extern "C"
