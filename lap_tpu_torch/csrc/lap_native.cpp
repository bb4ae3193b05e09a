// lap_tpu native host ops.
//
// The reference stack leans on library native code for its host data plane:
// TF kernels for image decode/resize and the sentencepiece C++ wheel for
// tokenization (SURVEY.md §2.8). This file provides the TPU-native rebuild's
// equivalents as a small self-contained shared library consumed via ctypes:
//
//   - bilinear resize-with-pad over uint8 HWC images (multithreaded batch)
//   - 180-degree rotation (wrist-camera convention)
//   - sentencepiece-style unigram Viterbi encoding over a piece vocabulary
//   - greedy lowest-rank-first BPE over integer symbol streams (FAST codec)
//
// Build: g++ -O3 -march=native -shared -fPIC -o liblap_native.so lap_native.cpp -lpthread
//
// The port's copy of csrc/lap_native.cpp (lap_tpu_torch/native.py builds and
// binds it, the bpe_* entry points as NativeIntBPE).

#include <algorithm>
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
// preserves aspect ratio (matches utils/image.resize_with_pad_np).
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

    double sy_scale = static_cast<double>(h) / rh;
    double sx_scale = static_cast<double>(w) / rw;
    for (int y = 0; y < rh; ++y) {
        // Pixel-center sampling (cv2.INTER_LINEAR convention).
        double sy = (y + 0.5) * sy_scale - 0.5;
        sy = std::max(0.0, std::min(sy, static_cast<double>(h - 1)));
        int iy = static_cast<int>(sy);
        int iy1 = std::min(iy + 1, h - 1);
        double fy = sy - iy;
        uint8_t* drow = dst + (static_cast<size_t>(y0 + y) * out_w + x0) * c;
        const uint8_t* srow0 = src + static_cast<size_t>(iy) * w * c;
        const uint8_t* srow1 = src + static_cast<size_t>(iy1) * w * c;
        for (int x = 0; x < rw; ++x) {
            double sx = (x + 0.5) * sx_scale - 0.5;
            sx = std::max(0.0, std::min(sx, static_cast<double>(w - 1)));
            int ix = static_cast<int>(sx);
            int ix1 = std::min(ix + 1, w - 1);
            double fx = sx - ix;
            for (int ch = 0; ch < c; ++ch) {
                double top = srow0[ix * c + ch] * (1 - fx) + srow0[ix1 * c + ch] * fx;
                double bot = srow1[ix * c + ch] * (1 - fx) + srow1[ix1 * c + ch] * fx;
                double val = top * (1 - fy) + bot * fy;
                drow[x * c + ch] = static_cast<uint8_t>(val + 0.5);
            }
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
