// Host-side hot loops of the PyTorch port: byte-level BPE encode and Q40/Q80
// block quantization for the `.m` writer and the converters. Built at first
// use with the host C++ compiler (dllama_tpu_torch/utils/native.py) and
// called through ctypes; every function has a pure-Python/numpy fallback with
// the same results, which tests/test_torch_native.py holds it to.
//
// Numeric contract: quantization matches the numpy codecs of
// dllama_tpu_torch/ops/quant.py bit for bit. f32->f16 rounds to nearest even
// (numpy astype), Q40 uses the reference's floor(x/delta + 8.5) rule with the
// unrounded f32 delta, and Q80 rounds half to even.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

uint16_t f32_to_f16(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    uint32_t sign = (x >> 16) & 0x8000u;
    uint32_t exp8 = (x >> 23) & 0xFFu;
    uint32_t mant = x & 0x7FFFFFu;
    if (exp8 == 0xFFu) return sign | 0x7C00u | (mant ? 0x200u : 0u);  // inf/nan
    int32_t exp = (int32_t)exp8 - 127 + 15;
    if (exp >= 0x1F) return sign | 0x7C00u;  // overflow -> inf
    if (exp <= 0) {                          // subnormal half
        if (exp < -10) return sign;          // underflow -> signed zero
        mant |= 0x800000u;
        uint32_t shift = (uint32_t)(14 - exp);
        uint32_t half = mant >> shift;
        uint32_t rem = mant & ((1u << shift) - 1u);
        uint32_t halfway = 1u << (shift - 1u);
        if (rem > halfway || (rem == halfway && (half & 1u))) half++;
        return (uint16_t)(sign | half);
    }
    uint32_t half = ((uint32_t)exp << 10) | (mant >> 13);
    uint32_t rem = mant & 0x1FFFu;
    if (rem > 0x1000u || (rem == 0x1000u && (half & 1u))) half++;  // carry ok
    return (uint16_t)(sign | half);
}

struct Tok {
    std::vector<std::string> vocab;
    std::vector<float> scores;
    std::unordered_map<std::string, int32_t> regular;
    std::vector<int32_t> specials;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- quantize

// x[n] f32 -> packed[n/32 * 16] u8 (byte j of block b = codes 32b+j | 32b+j+16<<4),
// scales[n/32] f16-as-u16. n must be a multiple of 32.
void dllama_quantize_q40(const float* x, int64_t n, uint8_t* packed, uint16_t* scales) {
    int64_t nb = n / 32;
    for (int64_t b = 0; b < nb; b++) {
        const float* g = x + b * 32;
        float mx = g[0], mn = g[0];
        for (int j = 1; j < 32; j++) {
            if (g[j] > mx) mx = g[j];
            if (g[j] < mn) mn = g[j];
        }
        float delta = ((-mn > mx) ? mn : mx) / -8.0f;
        scales[b] = f32_to_f16(delta);
        float inv = (delta != 0.0f) ? 1.0f / delta : 0.0f;
        uint8_t q[32];
        for (int j = 0; j < 32; j++) {
            float v = g[j] * inv + 8.5f;
            if (v < 0.0f) v = 0.0f;
            if (v > 15.0f) v = 15.0f;
            q[j] = (uint8_t)v;  // truncation == numpy astype(uint8) after clip
        }
        for (int j = 0; j < 16; j++) packed[b * 16 + j] = (uint8_t)(q[j] | (q[j + 16] << 4));
    }
}

// x[n] f32 -> codes[n] i8, scales[n/32] f16-as-u16.
void dllama_quantize_q80(const float* x, int64_t n, int8_t* codes, uint16_t* scales) {
    int64_t nb = n / 32;
    for (int64_t b = 0; b < nb; b++) {
        const float* g = x + b * 32;
        float am = 0.0f;
        for (int j = 0; j < 32; j++) {
            float a = std::fabs(g[j]);
            if (a > am) am = a;
        }
        float delta = am / 127.0f;
        scales[b] = f32_to_f16(delta);
        float inv = (delta != 0.0f) ? 1.0f / delta : 0.0f;
        for (int j = 0; j < 32; j++)
            codes[b * 32 + j] = (int8_t)std::nearbyintf(g[j] * inv);  // half-to-even
    }
}

// ---------------------------------------------------------------- tokenizer

// vocab: concatenated piece bytes + offsets[n_vocab+1]; special_ids are
// matched greedily as literal prefixes (in the given order) and excluded from
// the merge index. Returns an opaque handle.
void* dllama_tok_create(const uint8_t* blob, const int64_t* offsets, const float* scores,
                        int32_t n_vocab, const int32_t* special_ids, int32_t n_special) {
    Tok* t = new Tok();
    t->vocab.reserve(n_vocab);
    t->scores.assign(scores, scores + n_vocab);
    std::vector<char> is_special((size_t)n_vocab, 0);
    t->specials.reserve(n_special);
    for (int32_t i = 0; i < n_special; i++) {
        t->specials.push_back(special_ids[i]);
        if (special_ids[i] >= 0 && special_ids[i] < n_vocab) is_special[special_ids[i]] = 1;
    }
    for (int32_t i = 0; i < n_vocab; i++) {
        t->vocab.emplace_back((const char*)blob + offsets[i], (size_t)(offsets[i + 1] - offsets[i]));
        if (!is_special[i]) t->regular[t->vocab[i]] = i;  // later duplicate wins
    }
    return t;
}

void dllama_tok_destroy(void* h) { delete (Tok*)h; }

// Byte-level BPE encode with the exact semantics of Tokenizer.encode
// (greedy special prefix scan, byte accumulation, best-score pair merges,
// first occurrence wins ties). Returns token count, -1 if a byte sequence
// cannot be tokenized, -2 if out buffer is too small.
int32_t dllama_tok_encode(void* h, const uint8_t* data, int32_t n, int32_t add_special,
                          int32_t* out, int32_t max_out) {
    Tok* t = (Tok*)h;
    std::vector<int32_t> toks;
    std::string buf;
    int32_t i = 0;
    while (i < n) {
        if (add_special && buf.empty()) {
            int32_t sid = -1;
            for (int32_t cand : t->specials) {
                const std::string& piece = t->vocab[cand];
                if (!piece.empty() && (size_t)(n - i) >= piece.size() &&
                    std::memcmp(data + i, piece.data(), piece.size()) == 0) {
                    sid = cand;
                    break;
                }
            }
            if (sid >= 0) {
                toks.push_back(sid);
                i += (int32_t)t->vocab[sid].size();
                continue;
            }
        }
        buf.push_back((char)data[i]);
        i++;
        auto it = t->regular.find(buf);
        if (it != t->regular.end()) {
            toks.push_back(it->second);
            buf.clear();
        }
    }
    if (!buf.empty()) return -1;

    // Best-score pair merging via doubly-linked list + max-heap: O(n log n)
    // against the O(n^2) rescan of the Python fallback, with identical
    // results — the heap tie-breaks equal scores by the left token's original
    // position, which matches "first occurrence wins" because merges preserve
    // relative order.
    struct Node {
        int32_t id;
        int32_t prev, next;  // indices into nodes; -1 = end
        bool alive;
    };
    struct Cand {
        float score;
        int32_t pos;        // left node's original position (tie-break)
        int32_t left;       // node indices
        int32_t merged_id;
        int32_t left_id, right_id;  // staleness check
        bool operator<(const Cand& o) const {
            if (score != o.score) return score < o.score;   // max-heap on score
            return pos > o.pos;                             // then min position
        }
    };
    std::vector<Node> nodes(toks.size());
    for (size_t j = 0; j < toks.size(); j++)
        nodes[j] = {toks[j], (int32_t)j - 1, j + 1 < toks.size() ? (int32_t)(j + 1) : -1, true};

    std::priority_queue<Cand> heap;
    std::string merged;
    auto push_cand = [&](int32_t li) {
        int32_t ri = nodes[li].next;
        if (ri < 0) return;
        merged.assign(t->vocab[nodes[li].id]);
        merged += t->vocab[nodes[ri].id];
        auto it = t->regular.find(merged);
        if (it != t->regular.end())
            heap.push({t->scores[it->second], li, li, it->second, nodes[li].id, nodes[ri].id});
    };
    for (size_t j = 0; j + 1 < toks.size(); j++) push_cand((int32_t)j);

    size_t count = toks.size();
    while (!heap.empty()) {
        Cand c = heap.top();
        heap.pop();
        int32_t li = c.left;
        if (!nodes[li].alive || nodes[li].id != c.left_id) continue;
        int32_t ri = nodes[li].next;
        if (ri < 0 || nodes[ri].id != c.right_id) continue;
        nodes[li].id = c.merged_id;
        nodes[li].next = nodes[ri].next;
        if (nodes[ri].next >= 0) nodes[nodes[ri].next].prev = li;
        nodes[ri].alive = false;
        count--;
        if (nodes[li].prev >= 0) push_cand(nodes[li].prev);
        push_cand(li);
    }
    if ((int32_t)count > max_out) return -2;
    int32_t w = 0;
    for (int32_t j = 0; j >= 0 && j < (int32_t)nodes.size(); j = nodes[j].next)
        if (nodes[j].alive) out[w++] = nodes[j].id;
    return w;
}

}  // extern "C"
