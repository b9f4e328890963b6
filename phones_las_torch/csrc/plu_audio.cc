// plu_audio: native audio decoding for the phones_las_tpu data loader.
//
// The reference delegates audio IO to python libraries; this framework's
// host-side ingestion is native (SURVEY.md §3 "native components" —
// the rebuild supplies its own data-loader tier). Formats:
//   * WAV  (RIFF PCM 8/16-bit and float32)
//   * NIST SPHERE (TIMIT: pcm16 either endianness, ulaw; shorten -> error)
//   * FLAC (LibriSpeech: full subframe support — constant, verbatim,
//     fixed 0–4, LPC — rice/rice2 residuals, mono or stereo incl.
//     left/right/mid-side decorrelation, 8/12/16/20/24-bit)
// Output is always int16 mono (multi-channel averaged), matching the
// reference pipelines' expectations at 16 kHz corpora.
//
//   * MP3 (Common Voice's distribution format) via the system libmpg123,
//     loaded with dlopen at runtime (the reference leaned on external
//     decoders for mp3 too; SURVEY.md §3 Common Voice row)
// plus a rational polyphase resampler (Kaiser-windowed sinc) so 44.1/48
// kHz clips can be brought to the corpora's 16 kHz on the native path.
//
// C ABI (ctypes):
//   int plu_decode_audio(const char* path, int16_t** out, long long* n,
//                        int* sample_rate, char* err, int errlen);
//   int plu_resample(const int16_t* in, long long n, int in_rate,
//                    int out_rate, int16_t** out, long long* out_n,
//                    char* err, int errlen);
//   void plu_free(int16_t* buf);

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dlfcn.h>
#include <numeric>
#include <string>
#include <vector>

namespace {

struct ByteReader {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  bool ok = true;

  bool need(size_t n) {
    if (pos + n > size) { ok = false; return false; }
    return true;
  }
  const uint8_t* take(size_t n) {
    if (!need(n)) return nullptr;
    const uint8_t* p = data + pos;
    pos += n;
    return p;
  }
  uint32_t u32le() { auto* p = take(4); return p ? (uint32_t)p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24 : 0; }
  uint16_t u16le() { auto* p = take(2); return p ? (uint16_t)(p[0] | p[1] << 8) : 0; }
  uint32_t u24be() { auto* p = take(3); return p ? (uint32_t)p[0] << 16 | p[1] << 8 | p[2] : 0; }
};

// ---------------------------------------------------------------------------
// Bit reader (MSB-first) for FLAC
// ---------------------------------------------------------------------------
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;
  int bit_pos = 0;  // 0..7, MSB first
  bool ok = true;

  uint64_t bits(int n) {
    uint64_t v = 0;
    while (n > 0) {
      if (byte_pos >= size) { ok = false; return 0; }
      int avail = 8 - bit_pos;
      int take = n < avail ? n : avail;
      int shift = avail - take;
      v = (v << take) | ((data[byte_pos] >> shift) & ((1u << take) - 1));
      bit_pos += take;
      if (bit_pos == 8) { bit_pos = 0; byte_pos++; }
      n -= take;
    }
    return v;
  }
  int64_t sbits(int n) {
    uint64_t v = bits(n);
    if (n == 0) return 0;
    if (v & (1ull << (n - 1))) return (int64_t)(v | (~0ull << n));
    return (int64_t)v;
  }
  uint32_t unary() {
    uint32_t q = 0;
    while (ok) {
      if (bits(1)) return q;
      if (++q > 1u << 24) { ok = false; return 0; }  // corrupt stream guard
    }
    return 0;
  }
  void align() { if (bit_pos) { bit_pos = 0; byte_pos++; } }
};

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", msg.c_str());
}

// ---------------------------------------------------------------------------
// WAV
// ---------------------------------------------------------------------------
bool decode_wav(const std::vector<uint8_t>& buf, std::vector<int16_t>* out,
                int* rate, std::string* err) {
  ByteReader r{buf.data(), buf.size()};
  if (!r.need(12) || memcmp(buf.data(), "RIFF", 4) || memcmp(buf.data() + 8, "WAVE", 4)) {
    *err = "not a RIFF/WAVE file";
    return false;
  }
  r.pos = 12;
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  const uint8_t* data_ptr = nullptr;
  size_t data_len = 0;
  while (r.pos + 8 <= r.size) {
    const uint8_t* tag = r.take(4);
    uint32_t len = r.u32le();
    if (!r.ok || !r.need(len)) break;
    if (!memcmp(tag, "fmt ", 4)) {
      ByteReader f{buf.data() + r.pos, len};
      fmt = f.u16le();
      channels = f.u16le();
      sample_rate = f.u32le();
      f.u32le(); f.u16le();
      bits = f.u16le();
    } else if (!memcmp(tag, "data", 4)) {
      data_ptr = buf.data() + r.pos;
      data_len = len;
    }
    r.pos += len + (len & 1);
  }
  if (!data_ptr || !channels) { *err = "wav: missing fmt/data chunk"; return false; }
  if (bits != 8 && bits != 16 && bits != 24 && bits != 32) {
    *err = "wav: unsupported bit depth " + std::to_string(bits);
    return false;
  }
  *rate = (int)sample_rate;
  size_t bytes_per = bits / 8;
  size_t n_frames = data_len / (bytes_per * channels);
  out->resize(n_frames);
  for (size_t i = 0; i < n_frames; i++) {
    int64_t acc = 0;
    for (int c = 0; c < channels; c++) {
      const uint8_t* p = data_ptr + (i * channels + c) * bytes_per;
      int32_t s;
      if (fmt == 3 && bits == 32) {  // float32
        float f;
        memcpy(&f, p, 4);
        s = (int32_t)(f * 32767.0f);
      } else if (bits == 16) {
        s = (int16_t)(p[0] | p[1] << 8);
      } else if (bits == 8) {
        s = ((int32_t)p[0] - 128) << 8;
      } else if (bits == 24) {
        s = ((int32_t)((uint32_t)p[0] << 8 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 24)) >> 16;
      } else {  // bits == 32 int (depths validated above)
        int32_t v; memcpy(&v, p, 4); s = v >> 16;
      }
      acc += s;
    }
    acc /= channels;
    if (acc > 32767) acc = 32767;
    if (acc < -32768) acc = -32768;
    (*out)[i] = (int16_t)acc;
  }
  return true;
}

// ---------------------------------------------------------------------------
// NIST SPHERE
// ---------------------------------------------------------------------------
int16_t ulaw_to_pcm(uint8_t u) {
  u = ~u;
  int t = ((u & 0x0F) << 3) + 0x84;
  t <<= (u & 0x70) >> 4;
  return (u & 0x80) ? (int16_t)(0x84 - t) : (int16_t)(t - 0x84);
}

bool decode_sphere(const std::vector<uint8_t>& buf, std::vector<int16_t>* out,
                   int* rate, std::string* err) {
  if (buf.size() < 1024 || memcmp(buf.data(), "NIST_1A", 7)) {
    *err = "not a NIST_1A sphere file";
    return false;
  }
  std::string head((const char*)buf.data(), 1024);
  long hdr_size = strtol(head.c_str() + 8, nullptr, 10);
  if (hdr_size <= 0 || (size_t)hdr_size > buf.size()) { *err = "sphere: bad header size"; return false; }
  std::string hdr((const char*)buf.data(), hdr_size);

  auto field = [&](const char* name) -> std::string {
    size_t p = hdr.find(name);
    if (p == std::string::npos) return "";
    size_t eol = hdr.find('\n', p);
    std::string line = hdr.substr(p, eol - p);
    size_t sp = line.rfind(' ');
    return line.substr(sp + 1);
  };
  int sample_rate = atoi(field("sample_rate -i").c_str());
  int channels = atoi(field("channel_count -i").c_str());
  int nbytes = atoi(field("sample_n_bytes -i").c_str());
  std::string coding = field("sample_coding -s");
  std::string byte_fmt = field("sample_byte_format -s");
  if (channels <= 0) channels = 1;
  if (nbytes <= 0) nbytes = 2;
  if (sample_rate <= 0) sample_rate = 16000;
  if (coding.find("shorten") != std::string::npos || byte_fmt.find("shorten") != std::string::npos) {
    *err = "sphere: 'shorten' compression unsupported — convert with sph2pipe";
    return false;
  }
  *rate = sample_rate;
  const uint8_t* p = buf.data() + hdr_size;
  size_t data_len = buf.size() - hdr_size;
  bool ulaw = coding.find("ulaw") != std::string::npos ||
              (coding.empty() && nbytes == 1);
  size_t n_frames = data_len / ((ulaw ? 1 : nbytes) * channels);
  bool big = byte_fmt == "10";
  out->resize(n_frames);
  for (size_t i = 0; i < n_frames; i++) {
    int64_t acc = 0;
    for (int c = 0; c < channels; c++) {
      const uint8_t* q = p + (i * channels + c) * (ulaw ? 1 : nbytes);
      int16_t s;
      if (ulaw) s = ulaw_to_pcm(*q);
      else if (big) s = (int16_t)(q[0] << 8 | q[1]);
      else s = (int16_t)(q[0] | q[1] << 8);
      acc += s;
    }
    (*out)[i] = (int16_t)(acc / channels);
  }
  return true;
}

// ---------------------------------------------------------------------------
// FLAC
// ---------------------------------------------------------------------------
uint64_t flac_utf8(BitReader* br) {
  uint32_t b0 = (uint32_t)br->bits(8);
  int extra;
  uint64_t v;
  if (b0 < 0x80) return b0;
  else if ((b0 & 0xE0) == 0xC0) { v = b0 & 0x1F; extra = 1; }
  else if ((b0 & 0xF0) == 0xE0) { v = b0 & 0x0F; extra = 2; }
  else if ((b0 & 0xF8) == 0xF0) { v = b0 & 0x07; extra = 3; }
  else if ((b0 & 0xFC) == 0xF8) { v = b0 & 0x03; extra = 4; }
  else if ((b0 & 0xFE) == 0xFC) { v = b0 & 0x01; extra = 5; }
  else if (b0 == 0xFE) { v = 0; extra = 6; }
  else { br->ok = false; return 0; }
  for (int i = 0; i < extra; i++) v = (v << 6) | (br->bits(8) & 0x3F);
  return v;
}

bool flac_residual(BitReader* br, int blocksize, int order,
                   std::vector<int64_t>* resid, std::string* err) {
  int method = (int)br->bits(2);
  if (method > 1) { *err = "flac: bad residual method"; return false; }
  int plen = method == 0 ? 4 : 5;
  int porder = (int)br->bits(4);
  int nparts = 1 << porder;
  resid->resize(blocksize);
  int idx = order;
  for (int part = 0; part < nparts; part++) {
    int count = blocksize >> porder;
    if (part == 0) count -= order;
    if (count < 0 || idx + count > blocksize) { *err = "flac: bad partition"; return false; }
    int param = (int)br->bits(plen);
    if (param == (1 << plen) - 1) {  // escape: raw bits
      int rawbits = (int)br->bits(5);
      for (int i = 0; i < count; i++) (*resid)[idx++] = br->sbits(rawbits);
    } else {
      for (int i = 0; i < count; i++) {
        uint32_t q = br->unary();
        uint64_t lo = br->bits(param);
        uint64_t u = ((uint64_t)q << param) | lo;
        (*resid)[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
    if (!br->ok) { *err = "flac: truncated residual"; return false; }
  }
  return true;
}

bool flac_subframe(BitReader* br, int blocksize, int bps,
                   std::vector<int64_t>* out, std::string* err) {
  if (br->bits(1)) { *err = "flac: bad subframe padding"; return false; }
  int type = (int)br->bits(6);
  int wasted = 0;
  if (br->bits(1)) { wasted = 1 + (int)br->unary(); }
  if (wasted >= bps) {  // would leave bps <= 0 → negative shifts below
    *err = "flac: wasted bits exceed sample size";
    return false;
  }
  bps -= wasted;
  out->assign(blocksize, 0);

  if (type == 0) {  // constant
    int64_t v = br->sbits(bps);
    for (int i = 0; i < blocksize; i++) (*out)[i] = v;
  } else if (type == 1) {  // verbatim
    for (int i = 0; i < blocksize; i++) (*out)[i] = br->sbits(bps);
  } else if ((type & 0x38) == 0x08 && (type & 7) <= 4) {  // fixed
    int order = type & 7;
    if (order > blocksize) { *err = "flac: predictor order exceeds blocksize"; return false; }
    for (int i = 0; i < order; i++) (*out)[i] = br->sbits(bps);
    std::vector<int64_t> resid;
    if (!flac_residual(br, blocksize, order, &resid, err)) return false;
    for (int i = order; i < blocksize; i++) {
      int64_t p;
      switch (order) {
        case 0: p = 0; break;
        case 1: p = (*out)[i - 1]; break;
        case 2: p = 2 * (*out)[i - 1] - (*out)[i - 2]; break;
        case 3: p = 3 * (*out)[i - 1] - 3 * (*out)[i - 2] + (*out)[i - 3]; break;
        default: p = 4 * (*out)[i - 1] - 6 * (*out)[i - 2] + 4 * (*out)[i - 3] - (*out)[i - 4]; break;
      }
      (*out)[i] = p + resid[i];
    }
  } else if (type & 0x20) {  // LPC
    int order = (type & 0x1F) + 1;
    if (order > blocksize) { *err = "flac: predictor order exceeds blocksize"; return false; }
    for (int i = 0; i < order; i++) (*out)[i] = br->sbits(bps);
    int precision = (int)br->bits(4) + 1;
    if (precision == 16) { *err = "flac: bad lpc precision"; return false; }
    int shift = (int)br->sbits(5);
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; i++) coef[i] = br->sbits(precision);
    std::vector<int64_t> resid;
    if (!flac_residual(br, blocksize, order, &resid, err)) return false;
    for (int i = order; i < blocksize; i++) {
      int64_t acc = 0;
      for (int j = 0; j < order; j++) acc += coef[j] * (*out)[i - 1 - j];
      (*out)[i] = (acc >> shift) + resid[i];
    }
  } else {
    *err = "flac: reserved subframe type";
    return false;
  }
  if (wasted) for (int i = 0; i < blocksize; i++) (*out)[i] <<= wasted;
  return br->ok;
}

bool decode_flac(const std::vector<uint8_t>& buf, std::vector<int16_t>* out,
                 int* rate, std::string* err) {
  if (buf.size() < 42 || memcmp(buf.data(), "fLaC", 4)) {
    *err = "not a FLAC file";
    return false;
  }
  size_t pos = 4;
  int sample_rate = 0, channels = 0, bps = 0;
  uint64_t total_samples = 0;
  bool last = false;
  while (!last && pos + 4 <= buf.size()) {
    uint8_t h = buf[pos];
    last = h & 0x80;
    int type = h & 0x7F;
    uint32_t len = (uint32_t)buf[pos + 1] << 16 | buf[pos + 2] << 8 | buf[pos + 3];
    pos += 4;
    if (len > buf.size() - pos) {
      // unchecked, pos would run past the buffer and the frame reader's
      // size (buf.size() - pos) would underflow to a huge size_t → OOB
      *err = "flac: truncated metadata block";
      return false;
    }
    if (type == 0 && len >= 34) {  // STREAMINFO
      BitReader br{buf.data() + pos, len};
      br.bits(16); br.bits(16); br.bits(24); br.bits(24);
      sample_rate = (int)br.bits(20);
      channels = (int)br.bits(3) + 1;
      bps = (int)br.bits(5) + 1;
      total_samples = br.bits(36);
    }
    pos += len;
  }
  if (!sample_rate || !channels) { *err = "flac: missing STREAMINFO"; return false; }
  *rate = sample_rate;
  out->clear();
  // the 36-bit STREAMINFO count is attacker-controlled: reserve only what
  // the compressed payload could plausibly expand to, not up to 64 GiB
  if (total_samples)
    out->reserve(std::min<uint64_t>(total_samples, buf.size() * 4 + 65536));

  BitReader br{buf.data() + pos, buf.size() - pos};
  std::vector<std::vector<int64_t>> ch(channels);
  while (br.byte_pos < br.size - 1) {
    // frame header
    if (br.bits(14) != 0x3FFE) { *err = "flac: lost frame sync"; return false; }
    br.bits(1);  // reserved
    br.bits(1);  // blocking strategy
    int bs_code = (int)br.bits(4);
    int sr_code = (int)br.bits(4);
    int ch_asgn = (int)br.bits(4);
    int ss_code = (int)br.bits(3);
    br.bits(1);  // reserved
    flac_utf8(&br);
    int blocksize;
    switch (bs_code) {
      case 0: *err = "flac: reserved blocksize code"; return false;
      case 1: blocksize = 192; break;
      case 2: case 3: case 4: case 5: blocksize = 576 << (bs_code - 2); break;
      case 6: blocksize = (int)br.bits(8) + 1; break;
      case 7: blocksize = (int)br.bits(16) + 1; break;
      default: blocksize = 256 << (bs_code - 8); break;  // codes 8..15
    }
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    int frame_bps = bps;
    switch (ss_code) {
      case 1: frame_bps = 8; break;
      case 2: frame_bps = 12; break;
      case 4: frame_bps = 16; break;
      case 5: frame_bps = 20; break;
      case 6: frame_bps = 24; break;
      case 7: frame_bps = 32; break;
      default: break;
    }
    br.bits(8);  // header crc8 (not verified)
    if (!br.ok) { *err = "flac: truncated frame header"; return false; }

    if (ch_asgn > 10) { *err = "flac: reserved channel assignment"; return false; }
    int nch = ch_asgn < 8 ? ch_asgn + 1 : 2;
    if (nch > channels) { *err = "flac: frame channels exceed STREAMINFO"; return false; }
    for (int c = 0; c < nch; c++) {
      int sub_bps = frame_bps;
      if ((ch_asgn == 8 && c == 1) || (ch_asgn == 9 && c == 0) ||
          (ch_asgn == 10 && c == 1))
        sub_bps += 1;  // side channel
      if (!flac_subframe(&br, blocksize, sub_bps, &ch[c], err)) return false;
    }
    br.align();
    br.bits(16);  // frame crc16 (not verified)
    if (!br.ok) { *err = "flac: truncated frame"; return false; }

    // stereo decorrelation → interleave/average to mono int16
    for (int i = 0; i < blocksize; i++) {
      int64_t a, b, s;
      switch (ch_asgn) {
        case 8: a = ch[0][i]; b = a - ch[1][i]; break;          // left/side
        case 9: b = ch[1][i]; a = ch[0][i] + b; break;          // right/side
        case 10: {                                               // mid/side
          int64_t mid = ch[0][i], side = ch[1][i];
          a = ((mid << 1) | (side & 1)) + side;
          a >>= 1;
          b = a - side;
          break;
        }
        default: a = ch[0][i]; b = nch > 1 ? ch[1][i] : a; break;
      }
      s = nch > 1 ? (a + b) / 2 : a;
      if (frame_bps > 16) s >>= (frame_bps - 16);
      else if (frame_bps < 16) s <<= (16 - frame_bps);
      if (s > 32767) s = 32767;
      if (s < -32768) s = -32768;
      out->push_back((int16_t)s);
    }
    if (total_samples && out->size() >= total_samples) break;
  }
  return true;
}

// ---------------------------------------------------------------------------
// MP3 via system libmpg123 (dlopen — no link-time dependency)
// ---------------------------------------------------------------------------
struct Mpg123Api {
  void* lib = nullptr;
  int (*init)() = nullptr;
  void* (*new_)(const char*, int*) = nullptr;
  int (*open)(void*, const char*) = nullptr;
  int (*getformat)(void*, long*, int*, int*) = nullptr;
  int (*format_none)(void*) = nullptr;
  int (*format)(void*, long, int, int) = nullptr;
  int (*read)(void*, unsigned char*, size_t, size_t*) = nullptr;
  int (*close)(void*) = nullptr;
  void (*delete_)(void*) = nullptr;
  bool ok() const {
    return lib && init && new_ && open && getformat && format_none && format &&
           read && close && delete_;
  }
};

const Mpg123Api* mpg123_api() {
  static Mpg123Api api;
  static bool tried = false;
  if (!tried) {
    tried = true;
    api.lib = dlopen("libmpg123.so.0", RTLD_NOW | RTLD_LOCAL);
    if (!api.lib) api.lib = dlopen("libmpg123.so", RTLD_NOW | RTLD_LOCAL);
    if (api.lib) {
      auto sym = [&](const char* n) { return dlsym(api.lib, n); };
      api.init = (int (*)())sym("mpg123_init");
      api.new_ = (void* (*)(const char*, int*))sym("mpg123_new");
      api.open = (int (*)(void*, const char*))sym("mpg123_open");
      api.getformat = (int (*)(void*, long*, int*, int*))sym("mpg123_getformat");
      api.format_none = (int (*)(void*))sym("mpg123_format_none");
      api.format = (int (*)(void*, long, int, int))sym("mpg123_format");
      api.read = (int (*)(void*, unsigned char*, size_t, size_t*))sym("mpg123_read");
      api.close = (int (*)(void*))sym("mpg123_close");
      api.delete_ = (void (*)(void*))sym("mpg123_delete");
      if (api.init) api.init();
    }
  }
  return api.ok() ? &api : nullptr;
}

constexpr int MPG123_ENC_SIGNED_16 = 0xD0;  // mpg123.h enum value
constexpr int MPG123_OK_ = 0;
constexpr int MPG123_DONE_ = -12;
constexpr int MPG123_NEW_FORMAT_ = -11;

bool decode_mp3(const char* path, std::vector<int16_t>* out, int* rate,
                std::string* err) {
  const Mpg123Api* m = mpg123_api();
  if (!m) {
    *err = "mp3: system libmpg123 not available — convert clips to wav/flac";
    return false;
  }
  int e = 0;
  void* h = m->new_(nullptr, &e);
  if (!h) { *err = "mp3: mpg123_new failed"; return false; }
  bool ok = false;
  long r = 0;
  int channels = 0, enc = 0;
  std::vector<int16_t> buf(65536);
  do {
    if (m->open(h, path) != MPG123_OK_) { *err = "mp3: cannot open stream"; break; }
    if (m->getformat(h, &r, &channels, &enc) != MPG123_OK_ || r <= 0 ||
        channels <= 0) {
      *err = "mp3: cannot read stream format";
      break;
    }
    // lock the output format to s16 at the stream's native rate
    m->format_none(h);
    if (m->format(h, r, channels, MPG123_ENC_SIGNED_16) != MPG123_OK_) {
      *err = "mp3: cannot set s16 output";
      break;
    }
    size_t done = 0;
    int rc;
    // mpg123_read fills the byte buffer without aligning to PCM-frame
    // boundaries: carry leftover samples of a partial frame into the
    // next read, or the downmix would drop them and channel-misalign
    // (L averaged with the next frame's R) from there on
    std::vector<int16_t> carry;
    while (true) {
      rc = m->read(h, (unsigned char*)buf.data(), buf.size() * 2, &done);
      size_t n = done / 2;
      if (n) {
        if (channels == 1) {
          out->insert(out->end(), buf.begin(), buf.begin() + n);
        } else {  // downmix to mono
          carry.insert(carry.end(), buf.begin(), buf.begin() + n);
          size_t i = 0;
          for (; i + (size_t)channels <= carry.size(); i += channels) {
            int64_t acc = 0;
            for (int c = 0; c < channels; c++) acc += carry[i + c];
            out->push_back((int16_t)(acc / channels));
          }
          carry.erase(carry.begin(), carry.begin() + i);
        }
      }
      if (rc == MPG123_DONE_) { ok = true; break; }
      if (rc != MPG123_OK_ && rc != MPG123_NEW_FORMAT_) {
        *err = "mp3: decode error rc=" + std::to_string(rc);
        break;
      }
    }
  } while (false);
  m->close(h);
  m->delete_(h);
  if (ok && out->empty()) { *err = "mp3: empty stream"; ok = false; }
  *rate = (int)r;
  return ok;
}

// ---------------------------------------------------------------------------
// Rational polyphase resampler (Kaiser-windowed sinc)
// ---------------------------------------------------------------------------
double bessel_i0(double x) {
  // series expansion; converges fast for the beta range used here
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 64; k++) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-18 * sum) break;
  }
  return sum;
}

bool resample_rational(const std::vector<int16_t>& in, int in_rate,
                       int out_rate, std::vector<int16_t>* out,
                       std::string* err) {
  if (in_rate <= 0 || out_rate <= 0) { *err = "resample: bad rates"; return false; }
  if (in_rate == out_rate) { *out = in; return true; }
  int g = std::gcd(in_rate, out_rate);
  int64_t L = out_rate / g, M = in_rate / g;
  if (L > 4096 || M > 4096) { *err = "resample: ratio too complex"; return false; }
  // low-pass at the tighter Nyquist, in the upsampled (rate*L) domain
  const int K = 10;  // taps per zero crossing
  int64_t maxLM = L > M ? L : M;
  int64_t half = K * maxLM;  // filter half-length
  double fc = 0.945 / (double)maxLM;  // normalized cutoff (×π)
  double beta = 8.6;  // Kaiser beta ≈ 90 dB stopband
  std::vector<double> h(2 * half + 1);
  double i0b = bessel_i0(beta);
  for (int64_t j = -half; j <= half; j++) {
    double t = (double)j;
    double sinc = (j == 0) ? fc : std::sin(M_PI * fc * t) / (M_PI * t);
    double w = bessel_i0(beta * std::sqrt(1.0 - (t / half) * (t / half))) / i0b;
    h[j + half] = (double)L * sinc * w;  // gain L compensates zero-stuffing
  }
  int64_t n_in = (int64_t)in.size();
  int64_t n_out = (n_in * L + M - 1) / M;
  out->resize(n_out);
  for (int64_t n = 0; n < n_out; n++) {
    int64_t u = n * M;  // position in the upsampled grid
    // contributing input samples m: u - half <= m*L <= u + half
    int64_t m_lo = (u - half + L - 1) / L;
    int64_t m_hi = (u + half) / L;
    if (m_lo < 0) m_lo = 0;
    if (m_hi >= n_in) m_hi = n_in - 1;
    double acc = 0.0;
    for (int64_t m = m_lo; m <= m_hi; m++) {
      acc += h[u - m * L + half] * in[m];
    }
    if (acc > 32767.0) acc = 32767.0;
    if (acc < -32768.0) acc = -32768.0;
    (*out)[n] = (int16_t)std::lround(acc);
  }
  return true;
}

}  // namespace

extern "C" {

int plu_resample(const int16_t* in, long long n, int in_rate, int out_rate,
                 int16_t** out_buf, long long* out_n, char* err, int errlen) {
  std::vector<int16_t> inv(in, in + n), outv;
  std::string e;
  if (!resample_rational(inv, in_rate, out_rate, &outv, &e)) {
    set_err(err, errlen, e);
    return 1;
  }
  *out_buf = (int16_t*)malloc(outv.size() * sizeof(int16_t));
  memcpy(*out_buf, outv.data(), outv.size() * sizeof(int16_t));
  *out_n = (long long)outv.size();
  return 0;
}

int plu_decode_audio(const char* path, int16_t** out_buf, long long* n_samples,
                     int* sample_rate, char* err, int errlen) {
  FILE* f = fopen(path, "rb");
  if (!f) { set_err(err, errlen, std::string("cannot open ") + path); return 1; }
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(sz);
  if (fread(buf.data(), 1, sz, f) != (size_t)sz) {
    fclose(f);
    set_err(err, errlen, "short read");
    return 1;
  }
  fclose(f);

  std::vector<int16_t> samples;
  int rate = 0;
  std::string e;
  bool ok;
  if (sz >= 4 && !memcmp(buf.data(), "RIFF", 4)) ok = decode_wav(buf, &samples, &rate, &e);
  else if (sz >= 7 && !memcmp(buf.data(), "NIST_1A", 7)) ok = decode_sphere(buf, &samples, &rate, &e);
  else if (sz >= 4 && !memcmp(buf.data(), "fLaC", 4)) ok = decode_flac(buf, &samples, &rate, &e);
  else if (sz >= 3 && (!memcmp(buf.data(), "ID3", 3) ||
                       (sz >= 2 && buf[0] == 0xFF && (buf[1] & 0xE0) == 0xE0)))
    ok = decode_mp3(path, &samples, &rate, &e);
  else { ok = false; e = "unrecognized audio container"; }

  if (!ok) { set_err(err, errlen, e); return 1; }
  *out_buf = (int16_t*)malloc(samples.size() * sizeof(int16_t));
  memcpy(*out_buf, samples.data(), samples.size() * sizeof(int16_t));
  *n_samples = (long long)samples.size();
  *sample_rate = rate;
  return 0;
}

void plu_free(int16_t* buf) { free(buf); }

}  // extern "C"
