// Lossless JPEG (ITU-T T.81, 1992, SOF3) codec — the native runtime half of
// the MLV→DNG pipeline: decodes LJ92-compressed MLV video frames and encodes
// lossless-compressed CinemaDNG strips.
//
// Written from scratch against the T.81 Annex H process semantics used by
// Magic Lantern streams (single component, predictors 1-7, first sample
// 2^(P-1), first row predicts left, first column predicts above) and by
// DNG writers (two interleaved components for Bayer data, predictor 1).
//
// Exposed as a small C ABI consumed via ctypes (mlvfs_tpu_torch/codecs/lj92.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t bits = 0;
    int nbits = 0;
    bool bad = false;

    BitReader(const uint8_t* data, size_t len) : p(data), end(data + len) {}

    inline void fill() {
        // fast path: pull up to 8 stuffing-free bytes in one load. Partial
        // low bits of the last byte may be OR'd below the valid region; they
        // are the byte's true contents at their natural positions, so later
        // refills OR the same values — idempotent by construction.
        if (nbits <= 56 && p + 8 <= end) {
            uint64_t v;
            memcpy(&v, p, 8);
            // no 0xFF byte anywhere in the window (0xFF in v == zero byte
            // in ~v). Plain data 0x00 bytes are fine and stay on this path;
            // any 0xFF defers to the byte loop so its stuffing 0x00 (which
            // may sit beyond this window) is always consumed with it.
            uint64_t inv = ~v;
            if (!((inv - 0x0101010101010101ULL) & v & 0x8080808080808080ULL)) {
                v = __builtin_bswap64(v);
                bits |= v >> nbits;
                int k = (64 - nbits) >> 3;
                p += k;
                nbits += 8 * k;
                return;
            }
        }
        while (nbits <= 56) {
            if (p >= end) {
                // feed zeros past the end; decode loop bounds stop us
                bits |= 0;
                nbits += 8;
                continue;
            }
            uint8_t byte = *p++;
            if (byte == 0xFF) {
                // byte stuffing: FF 00 means literal FF; FFxx is a marker
                if (p < end && *p == 0x00) {
                    p++;
                } else {
                    // marker (e.g. EOI): treat as end of stream
                    p = end;
                }
            }
            bits |= (uint64_t)byte << (56 - nbits);
            nbits += 8;
        }
    }

};

struct Huff {
    // flat 16-bit lookup: value = (code length << 8) | ssss
    std::vector<uint16_t> lut;
    // first-level 8-bit lookup: the 64 KiB flat table misses L1 on nearly
    // every sample; codes are almost always <= 8 bits for raw sensor data,
    // so this 512 B L1-resident table resolves the common case and falls
    // back to the flat table for longer (or invalid) codes. By prefix-
    // freeness every 16-bit extension of a <=8-bit code decodes identically,
    // so lut8[i] = lut[i << 8] whenever that entry's length is <= 8.
    std::vector<uint16_t> lut8;

    bool build(const uint8_t* counts /*16*/, const uint8_t* symbols, int nsym) {
        lut.assign(1 << 16, 0xFFFF);
        uint32_t code = 0;
        int k = 0;
        for (int len = 1; len <= 16; len++) {
            for (int i = 0; i < counts[len - 1]; i++) {
                if (k >= nsym) return false;
                uint8_t ssss = symbols[k++];
                // SSSS classes are 0..16 in lossless JPEG; anything larger
                // would later drive oversized shifts in the bit reader
                if (ssss > 16) return false;
                // corrupt counts can overflow the code space: a length-len
                // code must fit in len bits or the LUT write runs past 64K
                if (code >= (1u << len)) return false;
                uint32_t base = code << (16 - len);
                uint32_t span = 1u << (16 - len);
                uint16_t entry = (uint16_t)((len << 8) | ssss);
                for (uint32_t j = 0; j < span; j++) lut[base + j] = entry;
                code++;
            }
            code <<= 1;
        }
        lut8.assign(256, 0xFFFF);
        for (int i = 0; i < 256; i++) {
            uint16_t e = lut[(uint32_t)i << 8];
            if (e != 0xFFFF && (e >> 8) <= 8) lut8[i] = e;
        }
        return true;
    }

};

inline uint16_t be16(const uint8_t* p) { return (uint16_t)((p[0] << 8) | p[1]); }

// Per-sample decode against a raw LUT pointer (the Huff/vector indirection
// per sample measurably slowed the hot loop).
static inline bool decode_lut(const uint16_t* lut8, const uint16_t* lut,
                              BitReader& br, int& diff) {
    if (br.nbits < 32) br.fill();  // one sample consumes at most 32 bits
    uint16_t e = lut8[(uint32_t)(br.bits >> 56)];
    if (__builtin_expect(e == 0xFFFF, 0)) {
        // long code (or invalid: the flat table then also reads 0xFFFF)
        e = lut[(uint32_t)(br.bits >> 48)];
        if (e == 0xFFFF) return false;
    }
    int len = e >> 8;
    int t = e & 0xFF;
    if (t == 0) {
        br.bits <<= len;
        br.nbits -= len;
        diff = 0;
    } else if (__builtin_expect(t == 16, 0)) {
        br.bits <<= len;
        br.nbits -= len;
        diff = 32768;
    } else {
        // extract the extra bits from the pre-shift buffer and consume
        // code + extra in ONE shift — the bit buffer's serial dependency
        // chain is the decode loop's critical path
        int x = (int)(uint32_t)((br.bits << len) >> (64 - t));
        br.bits <<= len + t;
        br.nbits -= len + t;
        if (x < (1 << (t - 1))) x -= (1 << t) - 1;
        diff = x;
    }
    return true;
}

// Hot scan loop, specialized per predictor and component count with the
// first row / first column peeled out — the per-sample branches, the
// predictor switch, and the Huff table indirection were a third of decode
// time when inside the inner loop. NC == 0 is the runtime-ncomp fallback.
template <int PRED, int NC>
static int decode_scan(BitReader& br, const Huff* huff, const int* comp_table,
                       int w, int h, int ncomp_rt, int defaultval, uint16_t* out) {
    const int ncomp = NC ? NC : ncomp_rt;
    const uint16_t* luts[4];
    const uint16_t* luts8[4];
    for (int c = 0; c < ncomp; c++) {
        luts[c] = huff[comp_table[c]].lut.data();
        luts8[c] = huff[comp_table[c]].lut8.data();
    }
    // Decode straight into the output buffer and read predictors back from
    // it: the stored u16 values are exactly the masked ints the old
    // prevrow/currow side arrays held, so this drops one store per sample
    // plus the row-swap bookkeeping (~10% of scan time on Bayer streams).
    const int rowlen = w * ncomp;
    for (int y = 0; y < h; y++) {
        uint16_t* orow = out + (size_t)y * rowlen;
        const uint16_t* prow = orow - rowlen;  // only dereferenced when y > 0
        // x == 0: default value (first row) or the pixel above
        for (int c = 0; c < ncomp; c++) {
            int diff;
            if (!decode_lut(luts8[c], luts[c], br, diff)) return -7;
            int px = (y == 0) ? defaultval : prow[c];
            orow[c] = (uint16_t)((px + diff) & 0xFFFF);
        }
        if (y == 0) {
            for (int x = 1; x < w; x++)
                for (int c = 0; c < ncomp; c++) {
                    int diff;
                    if (!decode_lut(luts8[c], luts[c], br, diff)) return -7;
                    int i = x * ncomp + c;
                    orow[i] = (uint16_t)((orow[i - ncomp] + diff) & 0xFFFF);  // left
                }
        } else {
            for (int x = 1; x < w; x++)
                for (int c = 0; c < ncomp; c++) {
                    int diff;
                    if (!decode_lut(luts8[c], luts[c], br, diff)) return -7;
                    int i = x * ncomp + c;
                    int px;
                    if (PRED == 0) px = 0;
                    else if (PRED == 1) px = orow[i - ncomp];
                    else if (PRED == 2) px = prow[i];
                    else if (PRED == 3) px = prow[i - ncomp];
                    else if (PRED == 4) px = orow[i - ncomp] + prow[i] - prow[i - ncomp];
                    else if (PRED == 5) px = orow[i - ncomp] + ((prow[i] - prow[i - ncomp]) >> 1);
                    else if (PRED == 6) px = prow[i] + ((orow[i - ncomp] - prow[i - ncomp]) >> 1);
                    else px = (orow[i - ncomp] + prow[i]) >> 1;
                    orow[i] = (uint16_t)((px + diff) & 0xFFFF);
                }
        }
    }
    return 0;
}

template <int PRED>
static int decode_scan_nc(BitReader& br, const Huff* huff, const int* comp_table,
                          int w, int h, int ncomp, int defaultval, uint16_t* out) {
    if (ncomp == 1)
        return decode_scan<PRED, 1>(br, huff, comp_table, w, h, ncomp, defaultval, out);
    if (ncomp == 2)
        return decode_scan<PRED, 2>(br, huff, comp_table, w, h, ncomp, defaultval, out);
    return decode_scan<PRED, 0>(br, huff, comp_table, w, h, ncomp, defaultval, out);
}

}  // namespace

extern "C" {

// returns 0 ok, <0 error. out must hold width*height*ncomp u16.
// width/height/bits/ncomp written to dims[0..3].
int lj92_decode_buf(const uint8_t* data, size_t len, uint16_t* out, size_t out_cap,
                    int* dims) {
    // find SOI
    size_t ix = 0;
    while (ix + 1 < len && !(data[ix] == 0xFF && data[ix + 1] == 0xD8)) ix++;
    if (ix + 1 >= len) return -1;
    ix += 2;

    Huff huff[4];
    bool have_huff[4] = {false, false, false, false};
    int bits = 0, h = 0, w = 0, ncomp = 0;
    int comp_table[4] = {0, 0, 0, 0};
    int pred = 1;
    size_t scan_data = 0;

    while (ix + 3 < len) {
        if (data[ix] != 0xFF) return -2;
        uint8_t marker = data[ix + 1];
        if (marker == 0xD9) break;  // EOI
        uint16_t seglen = be16(data + ix + 2);
        // every segment read below indexes seg[0..seglen-1]: reject any
        // segment whose declared length runs past the buffer (corrupt or
        // truncated stream) before touching it
        if (seglen < 2 || ix + 2 + (size_t)seglen > len) return -2;
        const uint8_t* seg = data + ix + 2;
        if (marker == 0xC4) {  // DHT — may hold several tables
            size_t p = 2;
            while (p + 17 <= seglen) {
                int id = seg[p] & 0x0F;
                const uint8_t* counts = seg + p + 1;
                int nsym = 0;
                for (int i = 0; i < 16; i++) nsym += counts[i];
                if (p + 17 + nsym > (size_t)seglen || id > 3) return -3;
                if (!huff[id].build(counts, seg + p + 17, nsym)) return -3;
                have_huff[id] = true;
                p += 17 + nsym;
            }
        } else if (marker == 0xC3) {  // SOF3
            if (seglen < 8) return -4;
            bits = seg[2];
            h = be16(seg + 3);
            w = be16(seg + 5);
            ncomp = seg[7];
            if (ncomp < 1 || ncomp > 4) return -4;
            if (bits < 2 || bits > 16) return -4;
        } else if (marker == 0xDA) {  // SOS
            if (seglen < 3) return -5;
            int ns = seg[2];
            if (ns < 1 || (size_t)(4 + 2 * ns) > (size_t)seglen) return -5;
            for (int i = 0; i < ns && i < 4; i++) {
                comp_table[i] = seg[4 + 2 * i] >> 4;
                if (comp_table[i] > 3) return -5;  // indexes huff[4]
            }
            pred = seg[3 + 2 * ns];
            scan_data = ix + 2 + seglen;
            break;
        }
        ix += 2 + seglen;
    }
    if (!scan_data || scan_data > len || !w || !h || !ncomp) return -5;
    if ((size_t)w * h * ncomp > out_cap) return -6;
    for (int c = 0; c < ncomp; c++)
        if (!have_huff[comp_table[c]]) return -3;

    dims[0] = w;
    dims[1] = h;
    dims[2] = bits;
    dims[3] = ncomp;

    BitReader br(data + scan_data, len - scan_data);
    int defaultval = 1 << (bits - 1);
    switch (pred) {  // predictor/ncomp-specialized hot loops (decode_scan)
        case 0: return decode_scan_nc<0>(br, huff, comp_table, w, h, ncomp, defaultval, out);
        case 1: return decode_scan_nc<1>(br, huff, comp_table, w, h, ncomp, defaultval, out);
        case 2: return decode_scan_nc<2>(br, huff, comp_table, w, h, ncomp, defaultval, out);
        case 3: return decode_scan_nc<3>(br, huff, comp_table, w, h, ncomp, defaultval, out);
        case 4: return decode_scan_nc<4>(br, huff, comp_table, w, h, ncomp, defaultval, out);
        case 5: return decode_scan_nc<5>(br, huff, comp_table, w, h, ncomp, defaultval, out);
        case 6: return decode_scan_nc<6>(br, huff, comp_table, w, h, ncomp, defaultval, out);
        case 7: return decode_scan_nc<7>(br, huff, comp_table, w, h, ncomp, defaultval, out);
        default: return -8;
    }
}

// Batch decode: n independent LJ92 streams → one (n, frame_samples) u16
// buffer, fanned out over hardware threads. One ctypes call per *batch*
// instead of per frame, and the per-frame Huffman decode (inherently
// sequential within a stream) parallelizes across frames — the reference
// gets the same effect from the FUSE thread pool (README.md:22-24).
// offsets[i], lens[i] locate stream i inside `data`. rcs[i] receives the
// per-frame status (same codes as lj92_decode_buf); a bad frame leaves its
// slice zeroed and does not fail the batch. Returns 0.
int lj92_decode_batch_buf(const uint8_t* data, const uint64_t* offsets,
                          const uint64_t* lens, int n_frames,
                          uint16_t* out, uint64_t frame_samples,
                          int* dims, int* rcs, int n_threads) {
    if (n_threads <= 0) {
        n_threads = (int)std::thread::hardware_concurrency();
        if (n_threads <= 0) n_threads = 1;
    }
    if (n_threads > n_frames) n_threads = n_frames > 0 ? n_frames : 1;
    auto worker = [&](int t) {
        int d[4];
        for (int i = t; i < n_frames; i += n_threads) {
            uint16_t* dst = out + (uint64_t)i * frame_samples;
            int rc = lj92_decode_buf(data + offsets[i], (size_t)lens[i], dst,
                                     (size_t)frame_samples, d);
            rcs[i] = rc;
            if (rc != 0) memset(dst, 0, frame_samples * sizeof(uint16_t));
            if (i == 0 && rc == 0) memcpy(dims, d, sizeof(d));
        }
    };
    if (n_threads == 1) {
        worker(0);
    } else {
        std::vector<std::thread> threads;
        threads.reserve(n_threads);
        for (int t = 0; t < n_threads; t++) threads.emplace_back(worker, t);
        for (auto& th : threads) th.join();
    }
    return 0;
}

}  // extern "C" — reopened below

extern "C" {

namespace {

struct BitWriter {
    // Writes through a raw cursor into the vector (grown in bulk) instead of
    // per-byte push_back: the capacity check + size bump per byte were the
    // bulk of emission time. Bit layout identical to the byte-loop form.
    std::vector<uint8_t>& buf;
    size_t pos;
    uint64_t bits = 0;
    int nbits = 0;
    explicit BitWriter(std::vector<uint8_t>& b) : buf(b), pos(b.size()) {
        buf.resize(buf.size() + 4096);
    }

    inline void put(uint32_t value, int n) {  // n <= 32 (code + extra bits)
        uint32_t mask = (n >= 32) ? 0xFFFFFFFFu : ((1u << n) - 1);
        bits |= (uint64_t)(value & mask) << (64 - nbits - n);
        nbits += n;
        // worst drain: 39 bits -> 4 bytes, x2 if every byte stuffs
        if (pos + 16 > buf.size()) buf.resize(buf.size() + (buf.size() >> 1) + 64);
        uint8_t* p = buf.data() + pos;
        while (nbits >= 8) {
            uint8_t byte = (uint8_t)(bits >> 56);
            *p++ = byte;
            if (byte == 0xFF) *p++ = 0x00;  // byte stuffing
            bits <<= 8;
            nbits -= 8;
        }
        pos = (size_t)(p - buf.data());
    }

    void flush() {
        if (nbits > 0) {
            if (pos + 2 > buf.size()) buf.resize(buf.size() + 64);
            uint8_t byte = (uint8_t)((bits >> 56) | ((1u << (8 - nbits)) - 1));  // pad 1s
            buf[pos++] = byte;
            if (byte == 0xFF) buf[pos++] = 0x00;
            bits = 0;
            nbits = 0;
        }
        buf.resize(pos);
    }
};

inline int ssss_of(int diff) {
    uint32_t a = diff < 0 ? (uint32_t)-diff : (uint32_t)diff;
    return a ? 32 - __builtin_clz(a) : 0;
}

}  // namespace

// Encode width x height x ncomp (interleaved) u16 samples as SOF3 predictor-1
// lossless JPEG. Returns encoded size, or <0 on error. Caller provides a
// buffer; required worst case ~ n_samples*3 + 64.
long lj92_encode_buf(const uint16_t* img, int width, int height, int ncomp, int bits,
                     uint8_t* out, size_t out_cap) {
    if (ncomp < 1 || ncomp > 4 || bits < 2 || bits > 16) return -1;
    size_t n = (size_t)width * height * ncomp;
    int rowlen = width * ncomp;
    int defaultval = 1 << (bits - 1);

    // pass 1: differences + SSSS histogram. Only the 16-bit differences are
    // kept (SSSS recomputes in one clz from the diff at emission time) —
    // the old int32 diffs + int16 ssss arrays tripled pass-2 memory traffic.
    std::vector<int16_t> diffs(n);
    size_t hist[17] = {0};
    for (int y = 0; y < height; y++) {
        const uint16_t* row = img + (size_t)y * rowlen;
        const uint16_t* prev = img + (size_t)(y - 1) * rowlen;
        int16_t* drow = diffs.data() + (size_t)y * rowlen;
        for (int i = 0; i < rowlen; i++) {
            int px;
            if (y == 0 && i < ncomp)
                px = defaultval;
            else if (y == 0)
                px = row[i - ncomp];
            else if (i < ncomp)
                px = prev[i];
            else
                px = row[i - ncomp];
            // reduce modulo 2^16 into [-32768, 32767] (T.81 H.1.2.1)
            int diff = (int16_t)((int)row[i] - px);
            drow[i] = (int16_t)diff;
            hist[ssss_of(diff)]++;
        }
    }

    // canonical Huffman code from the histogram (package-merge is overkill:
    // 17 symbols; use simple length-limited construction via sorted freq)
    // Build optimal prefix code with lengths <= 16 using Huffman algorithm.
    struct Node {
        size_t freq;
        int sym;  // -1 internal
        int l, r;
    };
    std::vector<Node> nodes;
    std::vector<int> active;
    for (int sIdx = 0; sIdx <= 16; sIdx++) {
        if (hist[sIdx]) {
            nodes.push_back({hist[sIdx], sIdx, -1, -1});
            active.push_back((int)nodes.size() - 1);
        }
    }
    if (active.empty()) {
        nodes.push_back({1, 0, -1, -1});
        active.push_back(0);
    }
    if (active.size() == 1) {  // need at least 1-bit codes
        nodes.push_back({0, (nodes[active[0]].sym + 1) % 17, -1, -1});
        active.push_back((int)nodes.size() - 1);
    }
    while (active.size() > 1) {
        // find two smallest
        int a = 0, b = 1;
        if (nodes[active[b]].freq < nodes[active[a]].freq) std::swap(a, b);
        for (size_t i = 2; i < active.size(); i++) {
            if (nodes[active[i]].freq < nodes[active[a]].freq) {
                b = a;
                a = (int)i;
            } else if (nodes[active[i]].freq < nodes[active[b]].freq) {
                b = (int)i;
            }
        }
        if (a > b) std::swap(a, b);
        Node parent{nodes[active[a]].freq + nodes[active[b]].freq, -1, active[a], active[b]};
        nodes.push_back(parent);
        active[a] = (int)nodes.size() - 1;
        active.erase(active.begin() + b);
    }
    // depths
    uint8_t codelen[17] = {0};
    struct StackE {
        int node;
        int depth;
    };
    std::vector<StackE> stack{{active[0], 0}};
    int maxdepth = 0;
    while (!stack.empty()) {
        StackE e = stack.back();
        stack.pop_back();
        const Node& nd = nodes[e.node];
        if (nd.sym >= 0) {
            codelen[nd.sym] = (uint8_t)(e.depth ? e.depth : 1);
            if (codelen[nd.sym] > maxdepth) maxdepth = codelen[nd.sym];
        } else {
            stack.push_back({nd.l, e.depth + 1});
            stack.push_back({nd.r, e.depth + 1});
        }
    }
    if (maxdepth > 16) {
        // flatten: fall back to fixed 5-bit-ish lengths (rare, tiny images)
        for (int sIdx = 0; sIdx <= 16; sIdx++) codelen[sIdx] = hist[sIdx] ? 5 : 0;
        // ensure prefix feasibility below via canonical assignment by length
    }

    // canonical assignment ordered by (length, symbol)
    uint8_t counts[16] = {0};
    uint8_t symbols[17];
    int nsym = 0;
    for (int lenv = 1; lenv <= 16; lenv++)
        for (int sIdx = 0; sIdx <= 16; sIdx++)
            if (codelen[sIdx] == lenv) {
                counts[lenv - 1]++;
                symbols[nsym++] = (uint8_t)sIdx;
            }
    // JPEG forbids the all-ones code of max length; the classic fix is to
    // bump one symbol deeper. Simpler: ensure no code is all-ones by adding
    // a dummy longest code when the code space is exactly full.
    // Compute code space usage:
    {
        long space = 0;
        for (int lenv = 1; lenv <= 16; lenv++) space += (long)counts[lenv - 1] << (16 - lenv);
        if (space >= (1 << 16) && counts[15] < 255 && nsym < 17) {
            // push: find the longest length with a code and demote code space
            // by adding one more bit to one symbol (standard Adobe approach)
            for (int lenv = 16; lenv >= 1; lenv--) {
                if (counts[lenv - 1] > 0 && lenv < 16) {
                    counts[lenv - 1]--;
                    counts[lenv]++;
                    break;
                }
            }
        }
    }

    uint16_t codes[17];
    uint8_t lens[17];
    {
        uint8_t bylen[17][17];
        uint8_t cnt[17] = {0};
        int k = 0;
        for (int lenv = 1; lenv <= 16; lenv++)
            for (int i = 0; i < counts[lenv - 1]; i++) bylen[lenv][cnt[lenv]++] = symbols[k++];
        uint32_t code = 0;
        for (int sIdx = 0; sIdx <= 16; sIdx++) lens[sIdx] = 0;
        for (int lenv = 1; lenv <= 16; lenv++) {
            for (int i = 0; i < cnt[lenv]; i++) {
                codes[bylen[lenv][i]] = (uint16_t)code;
                lens[bylen[lenv][i]] = (uint8_t)lenv;
                code++;
            }
            code <<= 1;
        }
    }

    // emit headers
    std::vector<uint8_t> buf;
    buf.reserve(n + 1024);
    auto push16 = [&](uint16_t v) {
        buf.push_back((uint8_t)(v >> 8));
        buf.push_back((uint8_t)v);
    };
    buf.push_back(0xFF);
    buf.push_back(0xD8);  // SOI
    buf.push_back(0xFF);
    buf.push_back(0xC4);  // DHT
    push16((uint16_t)(2 + 1 + 16 + nsym));
    buf.push_back(0x00);  // table id 0
    for (int i = 0; i < 16; i++) buf.push_back(counts[i]);
    {
        int k = 0;
        for (int lenv = 1; lenv <= 16; lenv++)
            for (int sIdx = 0; sIdx <= 16; sIdx++)
                if (lens[sIdx] == lenv) buf.push_back((uint8_t)sIdx), k++;
    }
    buf.push_back(0xFF);
    buf.push_back(0xC3);  // SOF3
    push16((uint16_t)(8 + 3 * ncomp));
    buf.push_back((uint8_t)bits);
    push16((uint16_t)height);
    push16((uint16_t)width);
    buf.push_back((uint8_t)ncomp);
    for (int c = 0; c < ncomp; c++) {
        buf.push_back((uint8_t)c);
        buf.push_back(0x11);  // 1x1 sampling
        buf.push_back(0x00);
    }
    buf.push_back(0xFF);
    buf.push_back(0xDA);  // SOS
    push16((uint16_t)(6 + 2 * ncomp));
    buf.push_back((uint8_t)ncomp);
    for (int c = 0; c < ncomp; c++) {
        buf.push_back((uint8_t)c);
        buf.push_back(0x00);  // DC table 0
    }
    buf.push_back(0x01);  // predictor 1
    buf.push_back(0x00);
    buf.push_back(0x00);

    // entropy-coded data: code + extra bits emitted as one <=31-bit put
    BitWriter bw(buf);
    for (size_t i = 0; i < n; i++) {
        int diff = diffs[i];
        int s = ssss_of(diff);
        if (s && s != 16) {
            uint32_t v = diff >= 0 ? (uint32_t)diff : (uint32_t)(diff + (1 << s) - 1);
            bw.put(((uint32_t)codes[s] << s) | (v & ((1u << s) - 1)), lens[s] + s);
        } else {
            bw.put(codes[s], lens[s]);
        }
    }
    bw.flush();
    buf.push_back(0xFF);
    buf.push_back(0xD9);  // EOI

    if (buf.size() > out_cap) return -2;
    memcpy(out, buf.data(), buf.size());
    return (long)buf.size();
}

// Batch encode: n same-sized frames → per-frame slices of `out`, fanned
// over hardware threads (one ctypes call per batch; each frame builds its
// own optimal Huffman table exactly as lj92_encode_buf does, so slices are
// byte-identical to per-frame calls). lens[i] receives the encoded size or
// a negative error code; a failed frame does not fail the batch.
int lj92_encode_batch_buf(const uint16_t* imgs, int n_frames, int width,
                          int height, int ncomp, int bits,
                          uint8_t* out, uint64_t per_cap, int64_t* lens,
                          int n_threads) {
    if (n_threads <= 0) {
        n_threads = (int)std::thread::hardware_concurrency();
        if (n_threads <= 0) n_threads = 1;
    }
    if (n_threads > n_frames) n_threads = n_frames > 0 ? n_frames : 1;
    const uint64_t frame_px = (uint64_t)width * height * ncomp;
    auto worker = [&](int t) {
        for (int i = t; i < n_frames; i += n_threads) {
            lens[i] = lj92_encode_buf(imgs + (uint64_t)i * frame_px, width,
                                      height, ncomp, bits,
                                      out + (uint64_t)i * per_cap, per_cap);
        }
    };
    if (n_threads == 1) {
        worker(0);
    } else {
        std::vector<std::thread> threads;
        threads.reserve(n_threads);
        for (int t = 0; t < n_threads; t++) threads.emplace_back(worker, t);
        for (auto& th : threads) th.join();
    }
    return 0;
}

}  // extern "C"
