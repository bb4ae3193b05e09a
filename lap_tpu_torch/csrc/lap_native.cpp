// lap_tpu native host ops.
//
// The reference stack leans on library native code for its host data plane:
// TF kernels for image decode/resize and the sentencepiece C++ wheel for
// tokenization (SURVEY.md §2.8). This file provides the TPU-native rebuild's
// equivalents as a small self-contained shared library consumed via ctypes:
//
//   - bilinear resize-with-pad over uint8 HWC images (multithreaded batch;
//     the port's copy computes as OpenCV's INTER_LINEAR, bit for bit)
//   - 180-degree rotation (wrist-camera convention)
//   - sentencepiece-style unigram Viterbi encoding over a piece vocabulary
//   - greedy lowest-rank-first BPE over integer symbol streams (FAST codec)
//   - the port's own: a baseline JPEG decoder/encoder and the PNG unfilter
//     (the data pipeline's frames; see the codec section at the end)
//
// Build: g++ -O3 -march=native -shared -fPIC -o liblap_native.so lap_native.cpp -lpthread
//
// The port's copy of csrc/lap_native.cpp (lap_tpu_torch/native.py builds and
// binds it, the bpe_* entry points as NativeIntBPE).

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Image ops
// ---------------------------------------------------------------------------

// Bilinear resize of one HWC uint8 image into a zero-padded canvas that
// preserves aspect ratio (utils/image.resize_with_pad_np), with the
// arithmetic of OpenCV's cv::resize(INTER_LINEAR) on 8-bit images, bit for
// bit: 11-bit fixed-point weights rounded from float (each of the pair on its
// own), exact integer row sums, and the vertical pass of its vector path,
// ((((S0 >> 4) * b0) >> 16) + (((S1 >> 4) * b1) >> 16) + 2) >> 2. Columns
// clamp the source position and weight at the edges; rows clamp only the
// rows read, not the weights.
static void linear_coeffs(int ssize, int dsize, bool clamp, std::vector<int>& ofs,
                          std::vector<int>& w0, std::vector<int>& w1) {
    double scale = 1.0 / (static_cast<double>(dsize) / ssize);
    ofs.resize(dsize);
    w0.resize(dsize);
    w1.resize(dsize);
    for (int d = 0; d < dsize; ++d) {
        float f = static_cast<float>((d + 0.5) * scale - 0.5);
        int s = static_cast<int>(std::floor(f));
        f -= static_cast<float>(s);
        if (clamp && s < 0) f = 0.f, s = 0;
        if (clamp && s >= ssize - 1) f = 0.f, s = ssize - 1;
        ofs[d] = s;
        w0[d] = static_cast<int>(std::lrintf((1.f - f) * 2048.f));
        w1[d] = static_cast<int>(std::lrintf(f * 2048.f));
    }
}

static void resize_one(const uint8_t* src, int h, int w, int c,
                       uint8_t* dst, int out_h, int out_w) {
    // float (not double) ratio math: matches the reference's TF fp32 scalar
    // arithmetic, which differs by one output pixel for shapes like 64x48.
    float ratio = std::max(static_cast<float>(h) / out_h,
                           static_cast<float>(w) / out_w);
    int rh = static_cast<int>(std::floor(static_cast<float>(h) / ratio));
    int rw = static_cast<int>(std::floor(static_cast<float>(w) / ratio));
    int y0 = (out_h - rh) / 2;
    int x0 = (out_w - rw) / 2;
    std::memset(dst, 0, static_cast<size_t>(out_h) * out_w * c);

    std::vector<int> xofs, xa0, xa1, yofs, yb0, yb1;
    linear_coeffs(w, rw, true, xofs, xa0, xa1);
    linear_coeffs(h, rh, false, yofs, yb0, yb1);
    // Horizontal pass of every source row (exact integers).
    std::vector<int32_t> hor(static_cast<size_t>(h) * rw * c);
    for (int y = 0; y < h; ++y) {
        const uint8_t* srow = src + static_cast<size_t>(y) * w * c;
        int32_t* hrow = &hor[static_cast<size_t>(y) * rw * c];
        for (int x = 0; x < rw; ++x) {
            const uint8_t* p0 = srow + static_cast<size_t>(xofs[x]) * c;
            const uint8_t* p1 = srow + static_cast<size_t>(std::min(xofs[x] + 1, w - 1)) * c;
            for (int ch = 0; ch < c; ++ch) hrow[x * c + ch] = p0[ch] * xa0[x] + p1[ch] * xa1[x];
        }
    }
    for (int y = 0; y < rh; ++y) {
        int r0 = std::min(std::max(yofs[y], 0), h - 1);
        int r1 = std::min(std::max(yofs[y] + 1, 0), h - 1);
        const int32_t* s0 = &hor[static_cast<size_t>(r0) * rw * c];
        const int32_t* s1 = &hor[static_cast<size_t>(r1) * rw * c];
        const int b0 = yb0[y], b1 = yb1[y];
        uint8_t* drow = dst + (static_cast<size_t>(y0 + y) * out_w + x0) * c;
        for (int i = 0; i < rw * c; ++i) {
            int v = ((((s0[i] >> 4) * b0) >> 16) + (((s1[i] >> 4) * b1) >> 16) + 2) >> 2;
            drow[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
        }
    }
}

// Batched resize-with-pad; images laid out [n, h, w, c] -> [n, out_h, out_w, c].
void resize_with_pad_u8(const uint8_t* src, int n, int h, int w, int c,
                        uint8_t* dst, int out_h, int out_w, int num_threads) {
    if (num_threads < 1) num_threads = 1;
    size_t in_stride = static_cast<size_t>(h) * w * c;
    size_t out_stride = static_cast<size_t>(out_h) * out_w * c;
    auto work = [&](int start, int step) {
        for (int i = start; i < n; i += step)
            resize_one(src + i * in_stride, h, w, c, dst + i * out_stride, out_h, out_w);
    };
    if (num_threads == 1 || n == 1) {
        work(0, 1);
        return;
    }
    std::vector<std::thread> threads;
    int t = std::min(num_threads, n);
    threads.reserve(t);
    for (int i = 0; i < t; ++i) threads.emplace_back(work, i, t);
    for (auto& th : threads) th.join();
}

// In-place 180-degree rotation of [h, w, c] uint8.
void rotate180_u8(uint8_t* img, int h, int w, int c) {
    size_t total = static_cast<size_t>(h) * w;
    for (size_t i = 0, j = total - 1; i < j; ++i, --j) {
        for (int ch = 0; ch < c; ++ch)
            std::swap(img[i * c + ch], img[j * c + ch]);
    }
}

// ---------------------------------------------------------------------------
// Tokenizer hot loop: unigram Viterbi over a piece vocabulary.
// ---------------------------------------------------------------------------

struct Vocab {
    std::unordered_map<std::string, int32_t> piece_to_id;
    std::vector<float> scores;
    std::vector<uint8_t> is_normal;  // NORMAL or USER_DEFINED
    int max_piece_len = 1;
    int unk_id = 0;
    float unk_penalty = -20.0f;
};

// pieces: concatenated UTF-8 bytes; offsets: n+1 byte offsets.
void* vocab_create(const char* pieces, const int64_t* offsets, const float* scores,
                   const uint8_t* normal_flags, int n, int unk_id) {
    auto* v = new Vocab();
    v->scores.assign(scores, scores + n);
    v->is_normal.assign(normal_flags, normal_flags + n);
    v->unk_id = unk_id;
    float min_score = 0.0f;
    for (int i = 0; i < n; ++i) {
        std::string piece(pieces + offsets[i], pieces + offsets[i + 1]);
        v->max_piece_len = std::max(v->max_piece_len, static_cast<int>(piece.size()));
        if (v->is_normal[i] && scores[i] < min_score) min_score = scores[i];
        v->piece_to_id.emplace(std::move(piece), i);
    }
    v->unk_penalty = min_score - 10.0f;
    return v;
}

void vocab_free(void* handle) { delete static_cast<Vocab*>(handle); }

// Viterbi segmentation of `text` (UTF-8, already normalized with the
// word-boundary marker); writes ids into out (capacity out_cap); returns count.
int unigram_encode(void* handle, const char* text, int text_len,
                   int32_t* out, int out_cap) {
    const Vocab& v = *static_cast<Vocab*>(handle);
    const float NEG = -1e18f;
    int n = text_len;
    if (n == 0) return 0;
    std::vector<float> best(n + 1, NEG);
    std::vector<int> prev(n + 1, -1);
    std::vector<int32_t> pick(n + 1, -1);
    best[0] = 0.0f;
    std::string key;
    key.reserve(v.max_piece_len);
    for (int i = 0; i < n; ++i) {
        if (best[i] <= NEG / 2) continue;
        int upper = std::min(n, i + v.max_piece_len);
        // UTF-8 continuation bytes can't start a piece boundary.
        for (int j = i + 1; j <= upper; ++j) {
            key.assign(text + i, text + j);
            auto it = v.piece_to_id.find(key);
            if (it == v.piece_to_id.end() || !v.is_normal[it->second]) continue;
            float s = best[i] + v.scores[it->second];
            if (s > best[j]) {
                best[j] = s;
                prev[j] = i;
                pick[j] = it->second;
            }
        }
        // unk fallback: advance one whole UTF-8 codepoint.
        int adv = 1;
        unsigned char b = text[i];
        if (b >= 0xF0) adv = 4; else if (b >= 0xE0) adv = 3; else if (b >= 0xC0) adv = 2;
        int j = std::min(n, i + adv);
        float s = best[i] + v.unk_penalty;
        if (s > best[j]) {
            best[j] = s;
            prev[j] = i;
            pick[j] = v.unk_id;
        }
    }
    // Backtrack.
    std::vector<int32_t> rev;
    int j = n;
    while (j > 0 && prev[j] >= 0) {
        rev.push_back(pick[j]);
        j = prev[j];
    }
    int count = static_cast<int>(rev.size());
    if (count > out_cap) count = out_cap;
    for (int i = 0; i < count; ++i) out[i] = rev[count - 1 - i];
    return count;
}

// ---------------------------------------------------------------------------
// FAST learned-BPE hot loop: greedy lowest-rank-first merging (GPT-2 bpe()).
// Semantics match lap_tpu/models/bpe.py IntBPE.encode exactly: find the
// globally lowest-rank adjacent pair, merge ALL its occurrences
// left-to-right, repeat until no registered pair remains.
// ---------------------------------------------------------------------------

struct BpeTable {
    std::unordered_map<uint64_t, int32_t> rank;  // (left<<32 | right) -> rank
    int32_t alphabet_size;
};

static inline uint64_t bpe_key(int32_t l, int32_t r) {
    return (static_cast<uint64_t>(static_cast<uint32_t>(l)) << 32) |
           static_cast<uint32_t>(r);
}

void* bpe_create(const int32_t* merges, int n_merges, int alphabet_size) {
    auto* t = new BpeTable();
    t->alphabet_size = alphabet_size;
    t->rank.reserve(static_cast<size_t>(n_merges) * 2);
    // operator[] (not emplace): a duplicated pair keeps the LAST rank,
    // matching the Python dict comprehension in IntBPE.__post_init__.
    for (int i = 0; i < n_merges; ++i)
        t->rank[bpe_key(merges[2 * i], merges[2 * i + 1])] = i;
    return t;
}

void bpe_free(void* handle) { delete static_cast<BpeTable*>(handle); }

// Encode seq (n ints) into out (capacity out_cap); returns token count.
int bpe_encode(void* handle, const int32_t* seq, int n, int32_t* out, int out_cap) {
    const BpeTable& t = *static_cast<BpeTable*>(handle);
    std::vector<int32_t> ids(seq, seq + n);
    std::vector<int32_t> next;
    next.reserve(n);
    while (ids.size() >= 2) {
        int32_t best_rank = INT32_MAX;
        for (size_t i = 0; i + 1 < ids.size(); ++i) {
            auto it = t.rank.find(bpe_key(ids[i], ids[i + 1]));
            if (it != t.rank.end() && it->second < best_rank) best_rank = it->second;
        }
        if (best_rank == INT32_MAX) break;
        // resolve the winning pair from its rank via a second scan (the rank
        // map is pair->rank; scanning again avoids storing the inverse).
        int32_t new_id = t.alphabet_size + best_rank;
        next.clear();
        size_t i = 0;
        while (i < ids.size()) {
            if (i + 1 < ids.size()) {
                auto it = t.rank.find(bpe_key(ids[i], ids[i + 1]));
                if (it != t.rank.end() && it->second == best_rank) {
                    next.push_back(new_id);
                    i += 2;
                    continue;
                }
            }
            next.push_back(ids[i]);
            ++i;
        }
        ids.swap(next);
    }
    int count = static_cast<int>(ids.size());
    if (count > out_cap) count = out_cap;
    for (int i = 0; i < count; ++i) out[i] = ids[i];
    return count;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG and PNG codec for the data pipeline's frames (no OpenCV or Pillow).
//
// Decode: baseline Huffman JPEG (SOF0/SOF1, 8-bit, 1 or 3 components, any
// integral sampling factors, restart markers, interleaved or one-component
// scans) to the bits that libjpeg-turbo gives with its defaults (what
// cv2.imdecode and Pillow call): the accurate integer IDCT of jidctint.c
// (jpeg_idct_islow) with its range-limit table, the "fancy" triangular
// upsampling of jdsample.c for 2:1 ratios (h2v1, h1v2, h2v2; box
// replication for other integral ratios and for planes 2 or fewer samples
// wide), and the integer YCbCr->RGB tables of jdcolor.c. The colour space
// follows jdapimin.c's default_decompress_parms (JFIF, Adobe transform,
// component ids). Progressive, lossless, arithmetic-coded, hierarchical and
// 12-bit files raise naming their SOF marker.
//
// Encode: baseline JPEG with the Annex K tables scaled by quality as
// jcparam.c does, 4:2:0 for colour (1x1 for grayscale), a float forward DCT.
//
// PNG: the row unfilter (all five filter types); the chunk walk and inflate
// are in lap_tpu_torch/native.py.
//
// Errors: the entry points return a negative value and codec_last_error()
// gives the message (per thread).
// ---------------------------------------------------------------------------

#include <stdexcept>

namespace {

thread_local std::string g_codec_error;
thread_local std::vector<uint8_t> g_encoded;

struct CodecError : std::runtime_error {
    explicit CodecError(const std::string& m) : std::runtime_error(m) {}
};

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // Extra entries: a corrupt run past 63 lands on 63 (jpeg_natural_order).
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct HuffTable {
    bool defined = false;
    uint8_t look_len[512];
    uint8_t look_val[512];
    int32_t maxcode[18];
    int32_t valptr[17];
    int32_t mincode[17];
    uint8_t vals[256];
};

void build_huff(HuffTable& t, const uint8_t* bits, const uint8_t* vals, int nvals) {
    std::memset(t.look_len, 0, sizeof(t.look_len));
    std::memcpy(t.vals, vals, nvals);
    int32_t code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
        t.valptr[l] = k;
        t.mincode[l] = code;
        for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
            if (code >= (1 << l)) throw CodecError("bad Huffman table");
            if (l <= 9) {
                int lo = code << (9 - l), hi = (code + 1) << (9 - l);
                for (int j = lo; j < hi; ++j) {
                    t.look_len[j] = static_cast<uint8_t>(l);
                    t.look_val[j] = vals[k];
                }
            }
        }
        t.maxcode[l] = bits[l - 1] ? code - 1 : -1;
        code <<= 1;
    }
    t.maxcode[17] = 0x7fffffff;
    t.defined = true;
}

struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t buf = 0;
    int bits = 0;
    bool marker = false;  // p stands on a marker: feed zeros (jdhuff.c)

    void fill() {
        while (bits <= 56) {
            uint64_t b = 0;
            if (!marker && p < end) {
                if (*p == 0xFF) {
                    if (p + 1 < end && p[1] == 0x00) {
                        b = 0xFF;
                        p += 2;
                    } else {
                        marker = true;
                    }
                } else {
                    b = *p++;
                }
            }
            buf |= b << (56 - bits);
            bits += 8;
        }
    }
    inline int get(int n) {
        if (bits < n) fill();
        int v = static_cast<int>(buf >> (64 - n));
        buf <<= n;
        bits -= n;
        return v;
    }
    inline int decode(const HuffTable& t) {
        if (bits < 16) fill();
        int idx = static_cast<int>(buf >> 55);
        int l = t.look_len[idx];
        if (l) {
            buf <<= l;
            bits -= l;
            return t.look_val[idx];
        }
        l = 10;
        int32_t code = static_cast<int32_t>(buf >> (64 - l));
        while (code > t.maxcode[l]) {
            ++l;
            if (l > 16) throw CodecError("corrupt JPEG data: bad Huffman code");
            code = static_cast<int32_t>(buf >> (64 - l));
        }
        buf <<= l;
        bits -= l;
        return t.vals[t.valptr[l] + code - t.mincode[l]];
    }
    inline int receive_extend(int s) {
        if (s == 0) return 0;
        int v = get(s);
        if (v < (1 << (s - 1))) v -= (1 << s) - 1;
        return v;
    }
    void reset() {
        buf = 0;
        bits = 0;
    }
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int dc_tbl = 0, ac_tbl = 0;
    int width = 0, height = 0;     // downsampled extent (jdinput.c)
    int bw = 0, bh = 0;            // allocated block grid (whole MCUs)
    bool q_latched = false;
    uint16_t q[64];
    std::vector<int16_t> coef;     // bh * bw * 64, natural order
    int pred = 0;
};

// ---- jidctint.c: jpeg_idct_islow --------------------------------------------
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// The post-IDCT range limit: index (x & 1023) for a sample value x - 128.
struct RangeLimit {
    uint8_t t[1024];
    RangeLimit() {
        for (int i = 0; i < 1024; ++i) {
            int v;
            if (i < 128) v = i + 128;
            else if (i < 512) v = 255;
            else if (i < 896) v = 0;
            else v = i - 896;
            t[i] = static_cast<uint8_t>(v);
        }
    }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t* ip = in + c;
        const uint16_t* qp = q + c;
        int* wp = ws + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
            int dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
            for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
            continue;
        }
        int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = ip[0] * qp[0];
        z3 = ip[32] * qp[32];
        int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = ip[56] * qp[56];
        tmp1 = ip[40] * qp[40];
        tmp2 = ip[24] * qp[24];
        tmp3 = ip[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        constexpr int s = CONST_BITS - PASS1_BITS;
        wp[0] = static_cast<int>(descale(tmp10 + tmp3, s));
        wp[56] = static_cast<int>(descale(tmp10 - tmp3, s));
        wp[8] = static_cast<int>(descale(tmp11 + tmp2, s));
        wp[48] = static_cast<int>(descale(tmp11 - tmp2, s));
        wp[16] = static_cast<int>(descale(tmp12 + tmp1, s));
        wp[40] = static_cast<int>(descale(tmp12 - tmp1, s));
        wp[24] = static_cast<int>(descale(tmp13 + tmp0, s));
        wp[32] = static_cast<int>(descale(tmp13 - tmp0, s));
    }
    for (int r = 0; r < 8; ++r) {
        const int* wp = ws + 8 * r;
        uint8_t* op = out + r * stride;
        if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
            uint8_t v = kRange.t[descale(wp[0], PASS1_BITS + 3) & 1023];
            for (int c = 0; c < 8; ++c) op[c] = v;
            continue;
        }
        int64_t z2 = wp[2], z3 = wp[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << CONST_BITS);
        int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        constexpr int s = CONST_BITS + PASS1_BITS + 3;
        op[0] = kRange.t[descale(tmp10 + tmp3, s) & 1023];
        op[7] = kRange.t[descale(tmp10 - tmp3, s) & 1023];
        op[1] = kRange.t[descale(tmp11 + tmp2, s) & 1023];
        op[6] = kRange.t[descale(tmp11 - tmp2, s) & 1023];
        op[2] = kRange.t[descale(tmp12 + tmp1, s) & 1023];
        op[5] = kRange.t[descale(tmp12 - tmp1, s) & 1023];
        op[3] = kRange.t[descale(tmp13 + tmp0, s) & 1023];
        op[4] = kRange.t[descale(tmp13 - tmp0, s) & 1023];
    }
}

// ---- jdcolor.c: build_ycc_rgb_table ----------------------------------------
struct YccTables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    YccTables() {
        constexpr int SCALEBITS = 16;
        constexpr int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
        auto fix = [](double x) { return static_cast<int64_t>(x * (1L << SCALEBITS) + 0.5); };
        for (int i = 0, x = -128; i < 256; ++i, ++x) {
            cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
            cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + ONE_HALF;
        }
    }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

const char* sof_name(int m) {
    switch (m) {
        case 0xC2: return "SOF2 (progressive)";
        case 0xC3: return "SOF3 (lossless)";
        case 0xC5: return "SOF5 (differential sequential)";
        case 0xC6: return "SOF6 (differential progressive)";
        case 0xC7: return "SOF7 (differential lossless)";
        case 0xC9: return "SOF9 (arithmetic sequential)";
        case 0xCA: return "SOF10 (arithmetic progressive)";
        case 0xCB: return "SOF11 (arithmetic lossless)";
        case 0xCD: return "SOF13 (arithmetic differential sequential)";
        case 0xCE: return "SOF14 (arithmetic differential progressive)";
        case 0xCF: return "SOF15 (arithmetic differential lossless)";
        default: return "unknown SOF";
    }
}

class JpegDecoder {
  public:
    JpegDecoder(const uint8_t* data, int64_t n) : d_(data), n_(n) {}

    int width = 0, height = 0, ncomp = 0;

    // Walks the markers; with `decode`, also decodes every scan.
    void run(bool decode) {
        if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) throw CodecError("not a JPEG file (no SOI marker)");
        pos_ = 2;
        for (;;) {
            int m = next_marker();
            if (m == 0xD9) break;  // EOI
            if (m >= 0xD0 && m <= 0xD7) continue;  // stray RSTn
            if (m == 0x01) continue;               // TEM
            int len = read_u16();
            if (len < 2 || pos_ + len - 2 > n_) throw CodecError("corrupt JPEG data: segment past the end");
            const uint8_t* seg = d_ + pos_;
            int64_t seg_end = pos_ + len - 2;
            switch (m) {
                case 0xC0:
                case 0xC1: parse_sof(seg, len - 2); if (!decode) return; break;
                case 0xC2: case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9: case 0xCA:
                case 0xCB: case 0xCD: case 0xCE: case 0xCF: {
                    char buf[160];
                    std::snprintf(buf, sizeof(buf), "unsupported JPEG: %s, marker 0xFF%02X; only baseline Huffman "
                                  "(SOF0/SOF1) is decoded", sof_name(m), m);
                    throw CodecError(buf);
                }
                case 0xC4: parse_dht(seg, len - 2); break;
                case 0xCC: throw CodecError("unsupported JPEG: DAC marker 0xFFCC (arithmetic coding)");
                case 0xDB: parse_dqt(seg, len - 2); break;
                case 0xDD: if (len < 4) throw CodecError("corrupt JPEG data: DRI"); restart_ = (seg[0] << 8) | seg[1]; break;
                case 0xDA:
                    if (!frame_) throw CodecError("corrupt JPEG data: SOS before SOF");
                    pos_ = seg_end;
                    decode_scan(seg, len - 2);
                    continue;
                case 0xE0:
                    if (len - 2 >= 5 && std::memcmp(seg, "JFIF\0", 5) == 0) saw_jfif_ = true;
                    break;
                case 0xEE:
                    if (len - 2 >= 12 && std::memcmp(seg, "Adobe", 5) == 0) {
                        saw_adobe_ = true;
                        adobe_transform_ = seg[11];
                    }
                    break;
                default: break;  // APPn, COM, DNL, ...
            }
            pos_ = seg_end;
        }
        if (!frame_) throw CodecError("corrupt JPEG data: no SOF marker");
    }

    // RGB (or gray replicated) into out[height][width][3].
    void output_rgb(uint8_t* out) {
        if (!scanned_) throw CodecError("corrupt JPEG data: no scan");
        std::vector<std::vector<uint8_t>> planes(ncomp);
        for (int ci = 0; ci < ncomp; ++ci) planes[ci] = full_plane(comps_[ci]);
        const size_t npx = static_cast<size_t>(width) * height;
        if (ncomp == 1) {
            const uint8_t* y = planes[0].data();
            for (size_t i = 0; i < npx; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
            return;
        }
        const uint8_t *p0 = planes[0].data(), *p1 = planes[1].data(), *p2 = planes[2].data();
        if (rgb_colorspace()) {
            for (size_t i = 0; i < npx; ++i) {
                out[3 * i] = p0[i];
                out[3 * i + 1] = p1[i];
                out[3 * i + 2] = p2[i];
            }
            return;
        }
        for (size_t i = 0; i < npx; ++i) {
            int y = p0[i], cb = p1[i], cr = p2[i];
            out[3 * i] = clamp255(y + kYcc.cr_r[cr]);
            out[3 * i + 1] = clamp255(y + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
            out[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
        }
    }

  private:
    const uint8_t* d_;
    int64_t n_;
    int64_t pos_ = 0;
    bool frame_ = false, scanned_ = false;
    bool saw_jfif_ = false, saw_adobe_ = false;
    int adobe_transform_ = 0;
    int restart_ = 0;
    int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
    uint16_t qt_[4][64];
    bool qt_defined_[4] = {false, false, false, false};
    HuffTable dc_[4], ac_[4];
    Component comps_[4];

    int read_u16() {
        if (pos_ + 2 > n_) throw CodecError("corrupt JPEG data: truncated");
        int v = (d_[pos_] << 8) | d_[pos_ + 1];
        pos_ += 2;
        return v;
    }

    int next_marker() {
        // Skip to 0xFF, then past fill bytes (jdmarker.c next_marker).
        while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;
        while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
        if (pos_ >= n_) {
            if (scanned_) return 0xD9;  // a missing EOI after the scans, as libjpeg tolerates
            throw CodecError("corrupt JPEG data: truncated before a marker");
        }
        return d_[pos_++];
    }

    bool rgb_colorspace() const {
        if (saw_jfif_) return false;
        if (saw_adobe_) return adobe_transform_ == 0;
        return comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66;
    }

    void parse_sof(const uint8_t* s, int len) {
        if (frame_) throw CodecError("corrupt JPEG data: two SOF markers");
        if (len < 6) throw CodecError("corrupt JPEG data: SOF");
        if (s[0] != 8) {
            char buf[96];
            std::snprintf(buf, sizeof(buf), "unsupported JPEG: %d-bit samples (SOF0/SOF1 at 8 bits only)", s[0]);
            throw CodecError(buf);
        }
        height = (s[1] << 8) | s[2];
        width = (s[3] << 8) | s[4];
        ncomp = s[5];
        if (height == 0 || width == 0) throw CodecError("unsupported JPEG: empty image or DNL height");
        if (ncomp != 1 && ncomp != 3) {
            char buf[96];
            std::snprintf(buf, sizeof(buf), "unsupported JPEG: %d components (1 or 3 only)", ncomp);
            throw CodecError(buf);
        }
        if (len < 6 + 3 * ncomp) throw CodecError("corrupt JPEG data: SOF");
        for (int i = 0; i < ncomp; ++i) {
            Component& c = comps_[i];
            c.id = s[6 + 3 * i];
            c.h = s[7 + 3 * i] >> 4;
            c.v = s[7 + 3 * i] & 15;
            c.tq = s[8 + 3 * i] & 3;
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) throw CodecError("corrupt JPEG data: sampling factor");
            hmax_ = std::max(hmax_, c.h);
            vmax_ = std::max(vmax_, c.v);
        }
        mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
        mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
        for (int i = 0; i < ncomp; ++i) {
            Component& c = comps_[i];
            if (hmax_ % c.h || vmax_ % c.v) throw CodecError("unsupported JPEG: fractional sampling factors");
            c.width = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax_ - 1) / hmax_);
            c.height = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax_ - 1) / vmax_);
            c.bw = mcux_ * c.h;
            c.bh = mcuy_ * c.v;
        }
        frame_ = true;
    }

    void parse_dqt(const uint8_t* s, int len) {
        int i = 0;
        while (i < len) {
            int pq = s[i] >> 4, tq = s[i] & 15;
            if (tq > 3) throw CodecError("corrupt JPEG data: DQT table id");
            ++i;
            int need = pq ? 128 : 64;
            if (i + need > len) throw CodecError("corrupt JPEG data: DQT");
            for (int k = 0; k < 64; ++k) {
                int v = pq ? (s[i + 2 * k] << 8) | s[i + 2 * k + 1] : s[i + k];
                qt_[tq][kNatural[k]] = static_cast<uint16_t>(v);
            }
            qt_defined_[tq] = true;
            i += need;
        }
    }

    void parse_dht(const uint8_t* s, int len) {
        int i = 0;
        while (i < len) {
            if (i + 17 > len) throw CodecError("corrupt JPEG data: DHT");
            int tc = s[i] >> 4, th = s[i] & 15;
            if (tc > 1 || th > 3) throw CodecError("corrupt JPEG data: DHT table id");
            const uint8_t* bits = s + i + 1;
            int count = 0;
            for (int l = 0; l < 16; ++l) count += bits[l];
            if (count > 256 || i + 17 + count > len) throw CodecError("corrupt JPEG data: DHT");
            build_huff(tc ? ac_[th] : dc_[th], bits, s + i + 17, count);
            i += 17 + count;
        }
    }

    void decode_block(BitReader& br, Component& c, int16_t* blk) {
        const HuffTable& dc = dc_[c.dc_tbl];
        const HuffTable& ac = ac_[c.ac_tbl];
        int t = br.decode(dc);
        if (t > 16) throw CodecError("corrupt JPEG data: DC category");
        c.pred += br.receive_extend(t);
        blk[0] = static_cast<int16_t>(c.pred);
        for (int k = 1; k < 64; ++k) {
            int rs = br.decode(ac);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                blk[kNatural[k]] = static_cast<int16_t>(br.receive_extend(s));
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
    }

    // After restart_ MCUs: drop the partial byte and pass one RSTn marker.
    void process_restart(BitReader& br) {
        br.reset();
        const uint8_t* p = br.p;
        while (p < br.end && *p != 0xFF) ++p;  // corrupt data before the marker
        while (p + 1 < br.end && p[0] == 0xFF && p[1] == 0xFF) ++p;
        if (p + 1 < br.end && p[1] >= 0xD0 && p[1] <= 0xD7) p += 2;
        br.p = p;
        br.marker = false;
        for (int i = 0; i < ncomp; ++i) comps_[i].pred = 0;
    }

    void decode_scan(const uint8_t* s, int len) {
        int ns = s[0];
        if (ns < 1 || ns > ncomp || len < 1 + 2 * ns + 3) throw CodecError("corrupt JPEG data: SOS");
        Component* sc[4];
        for (int i = 0; i < ns; ++i) {
            int id = s[1 + 2 * i];
            Component* c = nullptr;
            for (int k = 0; k < ncomp; ++k)
                if (comps_[k].id == id) c = &comps_[k];
            if (!c) throw CodecError("corrupt JPEG data: SOS names an unknown component");
            c->dc_tbl = s[2 + 2 * i] >> 4;
            c->ac_tbl = s[2 + 2 * i] & 15;
            if (c->dc_tbl > 3 || c->ac_tbl > 3 || !dc_[c->dc_tbl].defined || !ac_[c->ac_tbl].defined)
                throw CodecError("corrupt JPEG data: scan uses an undefined Huffman table");
            if (!c->q_latched) {  // jdinput.c latch_quant_tables: at the component's first scan
                if (!qt_defined_[c->tq]) throw CodecError("corrupt JPEG data: undefined quantization table");
                std::memcpy(c->q, qt_[c->tq], sizeof(c->q));
                c->q_latched = true;
            }
            if (c->coef.empty()) c->coef.assign(static_cast<size_t>(c->bw) * c->bh * 64, 0);
            c->pred = 0;
            sc[i] = c;
        }
        int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ahal = s[3 + 2 * ns];
        if (ss != 0 || se != 63 || ahal != 0) throw CodecError("corrupt JPEG data: not a sequential scan");
        BitReader br{d_ + pos_, d_ + n_};
        int64_t units, per_row;
        if (ns == 1) {
            per_row = (sc[0]->width + 7) / 8;
            units = per_row * ((sc[0]->height + 7) / 8);
        } else {
            per_row = mcux_;
            units = static_cast<int64_t>(mcux_) * mcuy_;
        }
        int todo = restart_;
        for (int64_t u = 0; u < units; ++u) {
            if (restart_ && todo == 0) {
                process_restart(br);
                todo = restart_;
            }
            int64_t uy = u / per_row, ux = u % per_row;
            if (ns == 1) {
                Component* c = sc[0];
                decode_block(br, *c, &c->coef[(static_cast<size_t>(uy) * c->bw + ux) * 64]);
            } else {
                for (int i = 0; i < ns; ++i) {
                    Component* c = sc[i];
                    for (int v = 0; v < c->v; ++v)
                        for (int h = 0; h < c->h; ++h) {
                            size_t by = uy * c->v + v, bx = ux * c->h + h;
                            decode_block(br, *c, &c->coef[(by * c->bw + bx) * 64]);
                        }
                }
            }
            --todo;
        }
        pos_ = br.p - d_;
        scanned_ = true;
    }

    // The component's samples upsampled to width x height (jdsample.c).
    std::vector<uint8_t> full_plane(const Component& c) {
        const int pw = c.bw * 8, ph = c.bh * 8;
        std::vector<uint8_t> plane(static_cast<size_t>(pw) * ph, 0);
        if (!c.coef.empty()) {
            for (int by = 0; by < c.bh; ++by)
                for (int bx = 0; bx < c.bw; ++bx)
                    idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.q,
                               &plane[static_cast<size_t>(by) * 8 * pw + bx * 8], pw);
        }
        const int rw = hmax_ / c.h, rh = vmax_ / c.v;
        const int cw = c.width, chh = c.height;
        std::vector<uint8_t> out(static_cast<size_t>(width) * height);
        auto in = [&](int y, int x) -> int { return plane[static_cast<size_t>(y) * pw + x]; };
        if (rw == 1 && rh == 1) {
            for (int y = 0; y < height; ++y) std::memcpy(&out[static_cast<size_t>(y) * width], &plane[static_cast<size_t>(y) * pw], width);
            return out;
        }
        const bool h2v1 = rw == 2 && rh == 1 && cw > 2;
        const bool h1v2 = rw == 1 && rh == 2;
        const bool h2v2 = rw == 2 && rh == 2 && cw > 2;
        if (h2v1) {
            for (int y = 0; y < height; ++y) {
                uint8_t* o = &out[static_cast<size_t>(y) * width];
                for (int x = 0; x < width; ++x) {
                    int i = x >> 1;
                    int near = in(y, i) * 3;
                    if (x & 1) o[x] = static_cast<uint8_t>((near + in(y, std::min(i + 1, cw - 1)) + 2) >> 2);
                    else o[x] = static_cast<uint8_t>((near + in(y, std::max(i - 1, 0)) + 1) >> 2);
                }
            }
            return out;
        }
        if (h1v2) {
            for (int y = 0; y < height; ++y) {
                int i = y >> 1;
                int far_row = (y & 1) ? std::min(i + 1, chh - 1) : std::max(i - 1, 0);
                int bias = (y & 1) ? 2 : 1;
                uint8_t* o = &out[static_cast<size_t>(y) * width];
                for (int x = 0; x < width; ++x) o[x] = static_cast<uint8_t>((in(i, x) * 3 + in(far_row, x) + bias) >> 2);
            }
            return out;
        }
        if (h2v2) {
            std::vector<int> colsum(cw);
            for (int y = 0; y < height; ++y) {
                int i = y >> 1;
                int far_row = (y & 1) ? std::min(i + 1, chh - 1) : std::max(i - 1, 0);
                for (int x = 0; x < cw; ++x) colsum[x] = in(i, x) * 3 + in(far_row, x);
                uint8_t* o = &out[static_cast<size_t>(y) * width];
                for (int x = 0; x < width; ++x) {
                    int j = x >> 1;
                    int cs = colsum[j] * 3;
                    if (x & 1) o[x] = static_cast<uint8_t>((cs + colsum[std::min(j + 1, cw - 1)] + 7) >> 4);
                    else o[x] = static_cast<uint8_t>((cs + colsum[std::max(j - 1, 0)] + 8) >> 4);
                }
            }
            return out;
        }
        // Box replication (h2v1/h2v2 at 2 samples or fewer, int_upsample).
        for (int y = 0; y < height; ++y) {
            uint8_t* o = &out[static_cast<size_t>(y) * width];
            for (int x = 0; x < width; ++x) o[x] = static_cast<uint8_t>(in(y / rh, x / rw));
        }
        return out;
    }
};

// ---- Encoder ---------------------------------------------------------------
const uint8_t kStdLumaQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                               14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                               18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                               49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                                 24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                                 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                                 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
    0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
    0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncHuff {
    uint16_t code[256];
    uint8_t size[256];
    EncHuff(const uint8_t* bits, const uint8_t* vals) {
        std::memset(size, 0, sizeof(size));
        int code_v = 0, k = 0;
        for (int l = 1; l <= 16; ++l) {
            for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code_v) {
                code[vals[k]] = static_cast<uint16_t>(code_v);
                size[vals[k]] = static_cast<uint8_t>(l);
            }
            code_v <<= 1;
        }
    }
};

struct BitWriter {
    std::vector<uint8_t>& out;
    uint32_t buf = 0;
    int bits = 0;
    explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
    void put(uint32_t v, int n) {
        buf = (buf << n) | (v & ((1u << n) - 1));
        bits += n;
        while (bits >= 8) {
            uint8_t b = static_cast<uint8_t>(buf >> (bits - 8));
            out.push_back(b);
            if (b == 0xFF) out.push_back(0);
            bits -= 8;
        }
    }
    void flush() {
        if (bits) put(0x7F, 8 - bits);  // pad with one bits
    }
};

void put_huff(BitWriter& bw, const EncHuff& h, int sym) {
    if (!h.size[sym]) throw CodecError("JPEG encoder: symbol missing from the Huffman table");
    bw.put(h.code[sym], h.size[sym]);
}

void encode_value(BitWriter& bw, const EncHuff& h, int run, int v, bool dc) {
    int a = v < 0 ? -v : v;
    int nbits = 0;
    while (a) {
        ++nbits;
        a >>= 1;
    }
    put_huff(bw, h, dc ? nbits : (run << 4) | nbits);
    if (nbits) bw.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), nbits);
}

struct Dct {
    double c[8][8];
    Dct() {
        for (int u = 0; u < 8; ++u)
            for (int x = 0; x < 8; ++x)
                c[u][x] = (u == 0 ? std::sqrt(0.125) : 0.5) * std::cos((2 * x + 1) * u * M_PI / 16.0);
    }
};
const Dct kDct;

void encode_block(BitWriter& bw, const float* px, int stride, const uint8_t* q, const EncHuff& dc,
                  const EncHuff& ac, int& pred) {
    double tmp[8][8], f[8][8];
    for (int y = 0; y < 8; ++y)
        for (int u = 0; u < 8; ++u) {
            double s = 0;
            for (int x = 0; x < 8; ++x) s += kDct.c[u][x] * (px[y * stride + x] - 128.0);
            tmp[y][u] = s;
        }
    for (int v = 0; v < 8; ++v)
        for (int u = 0; u < 8; ++u) {
            double s = 0;
            for (int y = 0; y < 8; ++y) s += kDct.c[v][y] * tmp[y][u];
            f[v][u] = s;
        }
    int zz[64];
    for (int k = 0; k < 64; ++k) {
        int n = kNatural[k];
        zz[k] = static_cast<int>(std::lround(f[n / 8][n % 8] / q[n]));
    }
    encode_value(bw, dc, 0, zz[0] - pred, true);
    pred = zz[0];
    int run = 0;
    for (int k = 1; k < 64; ++k) {
        if (zz[k] == 0) {
            ++run;
            continue;
        }
        while (run > 15) {
            put_huff(bw, ac, 0xF0);
            run -= 16;
        }
        encode_value(bw, ac, run, zz[k], false);
        run = 0;
    }
    if (run) put_huff(bw, ac, 0x00);
}

void put_u16(std::vector<uint8_t>& o, int v) {
    o.push_back(static_cast<uint8_t>(v >> 8));
    o.push_back(static_cast<uint8_t>(v & 255));
}

void put_dht(std::vector<uint8_t>& o, int cls_id, const uint8_t* bits, const uint8_t* vals) {
    int count = 0;
    for (int i = 0; i < 16; ++i) count += bits[i];
    o.push_back(0xFF);
    o.push_back(0xC4);
    put_u16(o, 2 + 1 + 16 + count);
    o.push_back(static_cast<uint8_t>(cls_id));
    o.insert(o.end(), bits, bits + 16);
    o.insert(o.end(), vals, vals + count);
}

void jpeg_encode_impl(const uint8_t* img, int h, int w, int c, int quality, std::vector<uint8_t>& o) {
    if (h < 1 || w < 1 || h > 65535 || w > 65535) throw CodecError("JPEG encoder: image size out of range");
    if (c != 1 && c != 3) throw CodecError("JPEG encoder: 1 or 3 channels only");
    quality = std::max(1, std::min(100, quality));
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;  // jcparam.c jpeg_quality_scaling
    uint8_t q[2][64];
    for (int i = 0; i < 64; ++i) {
        q[0][i] = static_cast<uint8_t>(std::max(1, std::min(255, (kStdLumaQ[i] * scale + 50) / 100)));
        q[1][i] = static_cast<uint8_t>(std::max(1, std::min(255, (kStdChromaQ[i] * scale + 50) / 100)));
    }
    const int ss = c == 3 ? 2 : 1;  // 4:2:0 for colour
    const int mcu = 8 * ss;
    const int pw = (w + mcu - 1) / mcu * mcu, ph = (h + mcu - 1) / mcu * mcu;
    // Planes padded by edge replication.
    std::vector<float> planes[3];
    for (int k = 0; k < c; ++k) planes[k].resize(static_cast<size_t>(pw) * ph);
    for (int y = 0; y < ph; ++y) {
        const uint8_t* row = img + static_cast<size_t>(std::min(y, h - 1)) * w * c;
        for (int x = 0; x < pw; ++x) {
            const uint8_t* p = row + static_cast<size_t>(std::min(x, w - 1)) * c;
            size_t i = static_cast<size_t>(y) * pw + x;
            if (c == 1) {
                planes[0][i] = p[0];
            } else {
                float r = p[0], g = p[1], b = p[2];
                planes[0][i] = 0.299f * r + 0.587f * g + 0.114f * b;
                planes[1][i] = -0.168736f * r - 0.331264f * g + 0.5f * b + 128.f;
                planes[2][i] = 0.5f * r - 0.418688f * g - 0.081312f * b + 128.f;
            }
        }
    }
    const int cw = pw / ss, ch = ph / ss;
    std::vector<float> sub[2];
    if (c == 3) {
        for (int k = 0; k < 2; ++k) {
            sub[k].resize(static_cast<size_t>(cw) * ch);
            const std::vector<float>& p = planes[k + 1];
            for (int y = 0; y < ch; ++y)
                for (int x = 0; x < cw; ++x) {
                    size_t i = static_cast<size_t>(2 * y) * pw + 2 * x;
                    sub[k][static_cast<size_t>(y) * cw + x] = 0.25f * (p[i] + p[i + 1] + p[i + pw] + p[i + pw + 1]);
                }
        }
    }
    o.clear();
    o.reserve(static_cast<size_t>(w) * h * c / 4 + 1024);
    const uint8_t soi_app0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01, 0x01,
                                0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
    o.insert(o.end(), soi_app0, soi_app0 + sizeof(soi_app0));
    for (int t = 0; t < (c == 3 ? 2 : 1); ++t) {
        o.push_back(0xFF);
        o.push_back(0xDB);
        put_u16(o, 2 + 65);
        o.push_back(static_cast<uint8_t>(t));
        for (int k = 0; k < 64; ++k) o.push_back(q[t][kNatural[k]]);
    }
    o.push_back(0xFF);
    o.push_back(0xC0);
    put_u16(o, 8 + 3 * c);
    o.push_back(8);
    put_u16(o, h);
    put_u16(o, w);
    o.push_back(static_cast<uint8_t>(c));
    for (int k = 0; k < c; ++k) {
        o.push_back(static_cast<uint8_t>(k + 1));
        o.push_back(k == 0 && c == 3 ? 0x22 : 0x11);
        o.push_back(k == 0 ? 0 : 1);
    }
    put_dht(o, 0x00, kDcLumaBits, kDcVals);
    put_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
    if (c == 3) {
        put_dht(o, 0x01, kDcChromaBits, kDcVals);
        put_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
    }
    o.push_back(0xFF);
    o.push_back(0xDA);
    put_u16(o, 6 + 2 * c);
    o.push_back(static_cast<uint8_t>(c));
    for (int k = 0; k < c; ++k) {
        o.push_back(static_cast<uint8_t>(k + 1));
        o.push_back(k == 0 ? 0x00 : 0x11);
    }
    o.push_back(0);
    o.push_back(63);
    o.push_back(0);
    static const EncHuff dc_l(kDcLumaBits, kDcVals), ac_l(kAcLumaBits, kAcLumaVals);
    static const EncHuff dc_c(kDcChromaBits, kDcVals), ac_c(kAcChromaBits, kAcChromaVals);
    BitWriter bw(o);
    int pred[3] = {0, 0, 0};
    if (c == 1) {
        // One component: a non-interleaved scan over ceil(w/8) x ceil(h/8) blocks.
        const int bw_n = (w + 7) / 8, bh_n = (h + 7) / 8;
        for (int by = 0; by < bh_n; ++by)
            for (int bx = 0; bx < bw_n; ++bx)
                encode_block(bw, &planes[0][static_cast<size_t>(by) * 8 * pw + bx * 8], pw, q[0], dc_l, ac_l, pred[0]);
    } else {
        for (int my = 0; my < ph / 16; ++my)
            for (int mx = 0; mx < pw / 16; ++mx) {
                for (int v = 0; v < 2; ++v)
                    for (int hh = 0; hh < 2; ++hh)
                        encode_block(bw, &planes[0][static_cast<size_t>(my * 16 + v * 8) * pw + mx * 16 + hh * 8], pw,
                                     q[0], dc_l, ac_l, pred[0]);
                for (int k = 0; k < 2; ++k)
                    encode_block(bw, &sub[k][static_cast<size_t>(my) * 8 * cw + mx * 8], cw, q[1], dc_c, ac_c,
                                 pred[k + 1]);
            }
    }
    bw.flush();
    o.push_back(0xFF);
    o.push_back(0xD9);
}

}  // namespace

extern "C" {

const char* codec_last_error() { return g_codec_error.c_str(); }

// Header only: height, width and components of a baseline JPEG. 0 or -1.
int jpeg_header(const uint8_t* data, int64_t n, int* h, int* w, int* ncomp) {
    try {
        JpegDecoder dec(data, n);
        dec.run(false);
        *h = dec.height;
        *w = dec.width;
        *ncomp = dec.ncomp;
        return 0;
    } catch (const std::exception& e) {
        g_codec_error = e.what();
        return -1;
    }
}

// Decode into out[h][w][3] (RGB; grayscale replicated). 0 or -1.
int jpeg_decode_rgb(const uint8_t* data, int64_t n, uint8_t* out, int h, int w) {
    try {
        JpegDecoder dec(data, n);
        dec.run(true);
        if (dec.height != h || dec.width != w) throw CodecError("jpeg_decode_rgb: size differs from the header");
        dec.output_rgb(out);
        return 0;
    } catch (const std::exception& e) {
        g_codec_error = e.what();
        return -1;
    }
}

// Encode [h][w][c] uint8 (c = 3 RGB or 1 gray) at `quality`; the bytes stay
// in a per-thread buffer that jpeg_encoded_copy() copies out. Returns the
// byte count or -1.
int64_t jpeg_encode(const uint8_t* img, int h, int w, int c, int quality) {
    try {
        jpeg_encode_impl(img, h, w, c, quality, g_encoded);
        return static_cast<int64_t>(g_encoded.size());
    } catch (const std::exception& e) {
        g_codec_error = e.what();
        return -1;
    }
}

void jpeg_encoded_copy(uint8_t* out) { std::memcpy(out, g_encoded.data(), g_encoded.size()); }

// PNG row unfilter: raw holds h rows of (1 filter byte + row_bytes); bpp is
// the bytes per complete pixel. Writes h * row_bytes bytes. 0 or -1.
int png_unfilter(const uint8_t* raw, int64_t raw_len, int h, int64_t row_bytes, int bpp, uint8_t* out) {
    if (raw_len < static_cast<int64_t>(h) * (row_bytes + 1)) {
        g_codec_error = "corrupt PNG data: image data shorter than its rows";
        return -1;
    }
    for (int y = 0; y < h; ++y) {
        const uint8_t* src = raw + static_cast<int64_t>(y) * (row_bytes + 1);
        int ft = src[0];
        ++src;
        uint8_t* dst = out + static_cast<int64_t>(y) * row_bytes;
        const uint8_t* up = y ? dst - row_bytes : nullptr;
        for (int64_t i = 0; i < row_bytes; ++i) {
            int a = i >= bpp ? dst[i - bpp] : 0;
            int b = up ? up[i] : 0;
            int c = (up && i >= bpp) ? up[i - bpp] : 0;
            int x = src[i];
            int v;
            switch (ft) {
                case 0: v = x; break;
                case 1: v = x + a; break;
                case 2: v = x + b; break;
                case 3: v = x + ((a + b) >> 1); break;
                case 4: {
                    int p = a + b - c;
                    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                    v = x + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c));
                    break;
                }
                default:
                    g_codec_error = "corrupt PNG data: filter type " + std::to_string(ft);
                    return -1;
            }
            dst[i] = static_cast<uint8_t>(v);
        }
    }
    return 0;
}

}  // extern "C"
