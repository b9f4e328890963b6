// plu_records: native reader for .plu utterance records.
//
// The hot ingestion path of the data tier (SURVEY.md §2 L2): mmap the
// record file, use the .idx offset table for random access, and fill
// padded device-ready batches (int16 audio, int32 targets with <eos>
// termination) directly into caller-provided buffers — no per-utterance
// Python parsing. Python fallback lives in phones_las_tpu/data/records.py.
//
// C ABI (ctypes):
//   void* plu_open(const char* path, char* err, int errlen);
//   long long plu_num_records(void* h);
//   int  plu_lengths(void* h, long long* out /* [n][3] */);
//   int  plu_read_batch(...);   // see below
//   void plu_close(void* h);

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Reader {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t size = 0;
  std::vector<uint64_t> offsets;
};

void set_err(char* err, int errlen, const std::string& m) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", m.c_str());
}

uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;  // little-endian hosts only (x86/arm64)
}

struct RecordView {
  const char* utt_id; uint32_t id_len;
  const int16_t* audio; uint32_t n_samples;
  const int32_t* targets; uint32_t n_targets;
  const int32_t* graphemes; uint32_t n_graphemes;
};

bool parse_record(const Reader* r, long long idx, RecordView* out) {
  if (idx < 0 || (size_t)idx >= r->offsets.size()) return false;
  uint64_t off = r->offsets[idx];
  if (off > r->size || r->size - off < 4) return false;
  const uint8_t* p = r->data + off;
  uint32_t rec_len = rd32(p);
  if (rec_len > r->size - off - 4) return false;
  const uint8_t* end = p + 4 + rec_len;
  p += 4;
  // Every length field is untrusted: bounds-check against the record end
  // BEFORE advancing, so a corrupt field can never walk p past the mmap.
  auto remain = [&](uint64_t n) { return (uint64_t)(end - p) >= n; };
  if (!remain(4)) return false;
  out->id_len = rd32(p); p += 4;
  if (!remain(out->id_len)) return false;
  out->utt_id = (const char*)p; p += out->id_len;
  if (!remain(4)) return false;
  out->n_samples = rd32(p); p += 4;
  if (!remain(2ull * out->n_samples)) return false;
  out->audio = (const int16_t*)p; p += 2ull * out->n_samples;
  if (!remain(4)) return false;
  out->n_targets = rd32(p); p += 4;
  if (!remain(4ull * out->n_targets)) return false;
  out->targets = (const int32_t*)p; p += 4ull * out->n_targets;
  if (!remain(4)) return false;
  out->n_graphemes = rd32(p); p += 4;
  if (!remain(4ull * out->n_graphemes)) return false;
  out->graphemes = (const int32_t*)p;
  return true;
}

}  // namespace

extern "C" {

void* plu_open(const char* path, char* err, int errlen) {
  Reader* r = new Reader();
  r->fd = open(path, O_RDONLY);
  if (r->fd < 0) { set_err(err, errlen, std::string("cannot open ") + path); delete r; return nullptr; }
  struct stat st;
  fstat(r->fd, &st);
  r->size = st.st_size;
  r->data = (const uint8_t*)mmap(nullptr, r->size, PROT_READ, MAP_PRIVATE, r->fd, 0);
  if (r->data == MAP_FAILED) { set_err(err, errlen, "mmap failed"); close(r->fd); delete r; return nullptr; }

  std::string idx_path = std::string(path) + ".idx";
  FILE* f = fopen(idx_path.c_str(), "rb");
  if (f) {
    fseek(f, 0, SEEK_END);
    long n = ftell(f) / 8;
    fseek(f, 0, SEEK_SET);
    r->offsets.resize(n);
    if (fread(r->offsets.data(), 8, n, f) != (size_t)n) r->offsets.clear();
    fclose(f);
  }
  if (r->offsets.empty() && r->size >= 4) {  // scan (index-less file)
    uint64_t hdr = rd32(r->data);
    uint64_t pos = 4 + hdr;
    while (pos + 4 <= r->size) {
      uint32_t rec_len = rd32(r->data + pos);
      if (rec_len > r->size - pos - 4) break;  // corrupt/truncated trailer
      r->offsets.push_back(pos);
      pos += 4 + (uint64_t)rec_len;
    }
  }
  return r;
}

long long plu_num_records(void* h) {
  return (long long)((Reader*)h)->offsets.size();
}

int plu_lengths(void* h, long long* out) {
  Reader* r = (Reader*)h;
  RecordView v;
  for (size_t i = 0; i < r->offsets.size(); i++) {
    if (!parse_record(r, i, &v)) return 1;
    out[3 * i] = v.n_samples;
    out[3 * i + 1] = v.n_targets;
    out[3 * i + 2] = v.n_graphemes;
  }
  return 0;
}

// Fills zero/pad-initialized buffers for `count` records:
//   audio            [count, audio_stride] int16 (truncated to stride)
//   audio_lengths    [count]
//   targets          [count, target_stride] int32, <eos>-terminated
//   target_lengths   [count] (includes <eos>)
//   graphemes/…      optional (pass NULL to skip), same convention
// `n_threads` > 1 splits the row fill across that many threads
// (row-interleaved; rows write disjoint slices, the mmap is read-only).
int plu_read_batch(void* h, const long long* indices, int count,
                   int16_t* audio, long long audio_stride, int* audio_lengths,
                   int32_t* targets, long long target_stride, int eos_id, int pad_id,
                   int* target_lengths,
                   int32_t* graphemes, long long grapheme_stride, int* grapheme_lengths,
                   int n_threads,
                   char* err, int errlen) {
  Reader* r = (Reader*)h;
  if (audio_stride < 1 || target_stride < 2 || (graphemes && grapheme_stride < 2)) {
    set_err(err, errlen, "bad stride");
    return 1;
  }
  auto fill_row = [&](int i) -> bool {
    RecordView v;
    if (!parse_record(r, indices[i], &v)) return false;
    long long ns = v.n_samples < (uint32_t)audio_stride ? v.n_samples : audio_stride;
    memset(audio + i * audio_stride, 0, audio_stride * 2);
    memcpy(audio + i * audio_stride, v.audio, ns * 2);
    audio_lengths[i] = (int)ns;

    long long nt = v.n_targets < (uint32_t)(target_stride - 1) ? v.n_targets : target_stride - 1;
    int32_t* trow = targets + i * target_stride;
    for (long long j = 0; j < target_stride; j++) trow[j] = pad_id;
    memcpy(trow, v.targets, nt * 4);
    trow[nt] = eos_id;
    target_lengths[i] = (int)(nt + 1);

    if (graphemes) {
      long long ng = v.n_graphemes < (uint32_t)(grapheme_stride - 1) ? v.n_graphemes : grapheme_stride - 1;
      int32_t* grow = graphemes + i * grapheme_stride;
      for (long long j = 0; j < grapheme_stride; j++) grow[j] = pad_id;
      memcpy(grow, v.graphemes, ng * 4);
      grow[ng] = eos_id;
      grapheme_lengths[i] = (int)(ng + 1);
    }
    return true;
  };

  if (n_threads > 1 && count > 1) {
    // Rows are independent (disjoint output slices over a read-only
    // mmap), so the fill parallelizes trivially. This is the multi-chip
    // serving feed path: one chip consumes ~5.7k utt/s and the serial
    // fill measures ~6.6k utt/s, so an N-chip DP server needs ~N cores
    // here to stay ahead of the mesh.
    if (n_threads > count) n_threads = count;
    std::atomic<long long> bad_index{-1};
    std::vector<std::thread> workers;
    workers.reserve(n_threads);
    for (int t = 0; t < n_threads; t++) {
      workers.emplace_back([&, t]() {
        for (int i = t; i < count; i += n_threads) {
          if (!fill_row(i)) { bad_index.store(indices[i]); return; }
        }
      });
    }
    for (auto& w : workers) w.join();
    if (bad_index.load() >= 0) {
      set_err(err, errlen, "bad record index " + std::to_string(bad_index.load()));
      return 1;
    }
    return 0;
  }

  for (int i = 0; i < count; i++) {
    if (!fill_row(i)) {
      set_err(err, errlen, "bad record index " + std::to_string(indices[i]));
      return 1;
    }
  }
  return 0;
}

void plu_close(void* h) {
  Reader* r = (Reader*)h;
  if (r->data) munmap((void*)r->data, r->size);
  if (r->fd >= 0) close(r->fd);
  delete r;
}

}  // extern "C"
