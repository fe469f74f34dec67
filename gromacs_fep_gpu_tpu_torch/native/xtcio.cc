// XTC compressed-trajectory codec (GROMACS interop).
//
// Wire format: reference src/gromacs/fileio/xtcio.cpp (frame header:
// magic 1995, natoms, step, time, 3x3 box) + the 3dfcoord compressed
// coordinate block of src/gromacs/fileio/libxdrf.cpp (quantize to ints,
// absolute values in a mixed-radix big integer sized by the coordinate
// range, runs of small inter-atom differences with an adaptively sized
// alphabet from the magicints table, MSB-first bit stream, XDR framing).
//
// The bitstream layout IS the interop spec, so the encoder's control
// flow necessarily mirrors the reference algorithm (same precedent as
// native/trrio.cc and utils/gmx_rng.py); the implementation here is
// original: 128-bit arithmetic replaces the reference's byte-array
// bignum, and the bit I/O is a simple MSB-first accumulator.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 xtcio.cc -o _xtcio.so
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

namespace {

constexpr int XTC_MAGIC = 1995;
constexpr int FIRSTIDX = 9;

const uint32_t MAGICINTS[] = {
    0,        0,        0,       0,       0,       0,       0,       0,
    0,        8,        10,      12,      16,      20,      25,      32,
    40,       50,       64,      80,      101,     128,     161,     203,
    256,      322,      406,     512,     645,     812,     1024,    1290,
    1625,     2048,     2580,    3250,    4096,    5060,    6501,    8192,
    10321,    13003,    16384,   20642,   26007,   32768,   41285,   52015,
    65536,    82570,    104031,  131072,  165140,  208063,  262144,  330280,
    416127,   524287,   660561,  832255,  1048576, 1321122, 1664510, 2097152,
    2642245,  3329021,  4194304, 5284491, 6658042, 8388607, 10568983,
    13316085, 16777216};
constexpr int LASTIDX = sizeof(MAGICINTS) / sizeof(*MAGICINTS);

// ---- XDR scalar framing (big-endian 4-byte records) ----
void put_be32(std::vector<unsigned char>& out, uint32_t v) {
    out.push_back((v >> 24) & 0xff);
    out.push_back((v >> 16) & 0xff);
    out.push_back((v >> 8) & 0xff);
    out.push_back(v & 0xff);
}
void put_f32(std::vector<unsigned char>& out, float f) {
    uint32_t v;
    std::memcpy(&v, &f, 4);
    put_be32(out, v);
}

struct ByteReader {
    const unsigned char* p;
    size_t n, pos = 0;
    bool ok = true;
    uint32_t be32() {
        if (pos + 4 > n) { ok = false; return 0; }
        uint32_t v = (uint32_t(p[pos]) << 24) | (uint32_t(p[pos + 1]) << 16)
                     | (uint32_t(p[pos + 2]) << 8) | uint32_t(p[pos + 3]);
        pos += 4;
        return v;
    }
    float f32() {
        uint32_t v = be32();
        float f;
        std::memcpy(&f, &v, 4);
        return f;
    }
};

// ---- MSB-first bit stream ----
struct BitWriter {
    std::vector<unsigned char> out;
    uint32_t acc = 0;
    int nacc = 0;
    void put(int nbits, uint32_t v) {
        while (nbits > 0) {
            int take = std::min(8 - nacc, nbits);
            acc = (acc << take) | ((v >> (nbits - take)) & ((1u << take) - 1));
            nacc += take;
            nbits -= take;
            if (nacc == 8) {
                out.push_back(static_cast<unsigned char>(acc));
                acc = 0;
                nacc = 0;
            }
        }
    }
    void flush() {
        if (nacc) {
            out.push_back(static_cast<unsigned char>(acc << (8 - nacc)));
            acc = 0;
            nacc = 0;
        }
    }
};

struct BitReader {
    const unsigned char* p;
    size_t n, pos = 0;
    uint32_t acc = 0;
    int nacc = 0;
    uint32_t get(int nbits) {
        uint32_t v = 0;
        while (nbits > 0) {
            if (nacc == 0) {
                acc = (pos < n) ? p[pos++] : 0;
                nacc = 8;
            }
            int take = std::min(nacc, nbits);
            v = (v << take) | ((acc >> (nacc - take)) & ((1u << take) - 1));
            nacc -= take;
            nbits -= take;
        }
        return v;
    }
};

// smallest b with 2^b > size (bits to hold values in [0, size])
int bits_for(uint32_t size) {
    int b = 0;
    uint64_t lim = 1;
    while (size >= lim && b < 32) {
        b++;
        lim <<= 1;
    }
    return b;
}

// bits to hold the mixed-radix product of three sizes
int bits_for3(const uint32_t s[3]) {
    unsigned __int128 p = (unsigned __int128)s[0] * s[1] * s[2];
    int b = 0;
    unsigned __int128 lim = 1;
    while (p >= lim) {
        b++;
        lim <<= 1;
    }
    return b;
}

// three values as one mixed-radix integer, low bytes first, padded to
// nbits total (the sendints wire layout)
void put_triplet(BitWriter& bw, int nbits, const uint32_t sizes[3],
                 const uint32_t nums[3]) {
    unsigned __int128 v =
        ((unsigned __int128)nums[0] * sizes[1] + nums[1]) * sizes[2] + nums[2];
    unsigned char bytes[16];
    int nb = 0;
    do {
        bytes[nb++] = static_cast<unsigned char>(v & 0xff);
        v >>= 8;
    } while (v);
    if (nbits >= nb * 8) {
        for (int i = 0; i < nb; i++) bw.put(8, bytes[i]);
        bw.put(nbits - nb * 8, 0);
    } else {
        for (int i = 0; i < nb - 1; i++) bw.put(8, bytes[i]);
        bw.put(nbits - (nb - 1) * 8, bytes[nb - 1]);
    }
}

void get_triplet(BitReader& br, int nbits, const uint32_t sizes[3],
                 int nums[3]) {
    unsigned char bytes[16];
    int nb = 0;
    while (nbits > 8) {
        bytes[nb++] = static_cast<unsigned char>(br.get(8));
        nbits -= 8;
    }
    if (nbits > 0) bytes[nb++] = static_cast<unsigned char>(br.get(nbits));
    unsigned __int128 v = 0;
    for (int i = nb - 1; i >= 0; i--) v = (v << 8) | bytes[i];
    nums[2] = static_cast<int>(v % sizes[2]);
    v /= sizes[2];
    nums[1] = static_cast<int>(v % sizes[1]);
    v /= sizes[1];
    nums[0] = static_cast<int>(v);
}

// ---- 3dfcoord compression ----
int quantize(float x, float prec) {
    float lf = (x >= 0.0f) ? x * prec + 0.5f : x * prec - 0.5f;
    return static_cast<int>(lf);
}

// append the compressed coordinate block (after natoms) to out
bool compress_coords(std::vector<unsigned char>& out, const float* x,
                     int natoms, float prec) {
    if (natoms <= 9) {
        for (int i = 0; i < natoms * 3; i++) put_f32(out, x[i]);
        return true;
    }
    put_f32(out, prec);

    std::vector<int> ip(static_cast<size_t>(natoms) * 3);
    int minint[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
    int maxint[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
    int mindiff = INT32_MAX;
    int prev[3] = {0, 0, 0};
    for (int i = 0; i < natoms; i++) {
        int diff = 0;
        for (int d = 0; d < 3; d++) {
            int v = quantize(x[i * 3 + d], prec);
            ip[i * 3 + d] = v;
            minint[d] = std::min(minint[d], v);
            maxint[d] = std::max(maxint[d], v);
            diff += std::abs(prev[d] - v);
            prev[d] = v;
        }
        if (i >= 1 && diff < mindiff) mindiff = diff;
    }
    for (int d = 0; d < 3; d++) put_be32(out, static_cast<uint32_t>(minint[d]));
    for (int d = 0; d < 3; d++) put_be32(out, static_cast<uint32_t>(maxint[d]));

    uint32_t sizeint[3], bitsizeint[3] = {0, 0, 0};
    for (int d = 0; d < 3; d++)
        sizeint[d] = static_cast<uint32_t>(maxint[d] - minint[d] + 1);
    int bitsize;
    if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffffu) {
        for (int d = 0; d < 3; d++) bitsizeint[d] = bits_for(sizeint[d]);
        bitsize = 0;
    } else {
        bitsize = bits_for3(sizeint);
    }

    int smallidx = FIRSTIDX;
    while (smallidx < LASTIDX && static_cast<int>(MAGICINTS[smallidx]) < mindiff)
        smallidx++;
    put_be32(out, static_cast<uint32_t>(smallidx));

    const int maxidx = std::min(LASTIDX, smallidx + 8);
    const int minidx = maxidx - 8;
    int smaller = MAGICINTS[std::max(FIRSTIDX, smallidx - 1)] / 2;
    int smallnum = MAGICINTS[smallidx] / 2;
    uint32_t sizesmall[3];
    sizesmall[0] = sizesmall[1] = sizesmall[2] = MAGICINTS[smallidx];
    const int larger = MAGICINTS[maxidx] / 2;

    BitWriter bw;
    int prevrun = -1;
    int prevcoord[3] = {0, 0, 0};
    uint32_t tmpc[30];
    int i = 0;
    while (i < natoms) {
        int is_small = 0;
        int* tc = &ip[static_cast<size_t>(i) * 3];
        int is_smaller;
        if (smallidx < maxidx && i >= 1
            && std::abs(tc[0] - prevcoord[0]) < larger
            && std::abs(tc[1] - prevcoord[1]) < larger
            && std::abs(tc[2] - prevcoord[2]) < larger) {
            is_smaller = 1;
        } else if (smallidx > minidx) {
            is_smaller = -1;
        } else {
            is_smaller = 0;
        }
        if (i + 1 < natoms && std::abs(tc[0] - tc[3]) < smallnum
            && std::abs(tc[1] - tc[4]) < smallnum
            && std::abs(tc[2] - tc[5]) < smallnum) {
            // water trick: swap so the in-between atom leads the run
            std::swap(tc[0], tc[3]);
            std::swap(tc[1], tc[4]);
            std::swap(tc[2], tc[5]);
            is_small = 1;
        }
        uint32_t abs3[3] = {static_cast<uint32_t>(tc[0] - minint[0]),
                            static_cast<uint32_t>(tc[1] - minint[1]),
                            static_cast<uint32_t>(tc[2] - minint[2])};
        if (bitsize == 0) {
            bw.put(bitsizeint[0], abs3[0]);
            bw.put(bitsizeint[1], abs3[1]);
            bw.put(bitsizeint[2], abs3[2]);
        } else {
            put_triplet(bw, bitsize, sizeint, abs3);
        }
        prevcoord[0] = tc[0];
        prevcoord[1] = tc[1];
        prevcoord[2] = tc[2];
        tc += 3;
        i++;

        int run = 0;
        if (is_small == 0 && is_smaller == -1) is_smaller = 0;
        while (is_small && run < 8 * 3) {
            if (is_smaller == -1) {
                // the reference computes this distance in 32-bit int
                // arithmetic, which WRAPS for large in-run diffs (each
                // component < smallnum, so SQR can exceed 2^31); the
                // wire format depends on that wrap, so replicate it in
                // well-defined unsigned arithmetic
                uint32_t d0 = static_cast<uint32_t>(tc[0] - prevcoord[0]);
                uint32_t d1 = static_cast<uint32_t>(tc[1] - prevcoord[1]);
                uint32_t d2 = static_cast<uint32_t>(tc[2] - prevcoord[2]);
                int32_t s2 = static_cast<int32_t>(d0 * d0 + d1 * d1 + d2 * d2);
                int32_t sm2 = static_cast<int32_t>(
                    static_cast<uint32_t>(smaller)
                    * static_cast<uint32_t>(smaller));
                if (s2 >= sm2) is_smaller = 0;
            }
            tmpc[run++] = static_cast<uint32_t>(tc[0] - prevcoord[0] + smallnum);
            tmpc[run++] = static_cast<uint32_t>(tc[1] - prevcoord[1] + smallnum);
            tmpc[run++] = static_cast<uint32_t>(tc[2] - prevcoord[2] + smallnum);
            prevcoord[0] = tc[0];
            prevcoord[1] = tc[1];
            prevcoord[2] = tc[2];
            i++;
            tc += 3;
            is_small = 0;
            if (i < natoms && std::abs(tc[0] - prevcoord[0]) < smallnum
                && std::abs(tc[1] - prevcoord[1]) < smallnum
                && std::abs(tc[2] - prevcoord[2]) < smallnum) {
                is_small = 1;
            }
        }
        if (run != prevrun || is_smaller != 0) {
            prevrun = run;
            bw.put(1, 1);
            bw.put(5, static_cast<uint32_t>(run + is_smaller + 1));
        } else {
            bw.put(1, 0);
        }
        for (int k = 0; k < run; k += 3)
            put_triplet(bw, smallidx, sizesmall, &tmpc[k]);
        if (is_smaller != 0) {
            smallidx += is_smaller;
            if (is_smaller < 0) {
                smallnum = smaller;
                smaller = MAGICINTS[smallidx - 1] / 2;
            } else {
                smaller = smallnum;
                smallnum = MAGICINTS[smallidx] / 2;
            }
            sizesmall[0] = sizesmall[1] = sizesmall[2] = MAGICINTS[smallidx];
        }
    }
    bw.flush();

    put_be32(out, static_cast<uint32_t>(bw.out.size()));
    out.insert(out.end(), bw.out.begin(), bw.out.end());
    while (out.size() % 4) out.push_back(0);  // xdr_opaque pad
    return true;
}

bool decompress_coords(ByteReader& r, float* x, int natoms, float* prec_out) {
    if (natoms <= 9) {
        for (int i = 0; i < natoms * 3; i++) x[i] = r.f32();
        if (prec_out) *prec_out = -1.0f;
        return r.ok;
    }
    float prec = r.f32();
    if (prec_out) *prec_out = prec;
    int minint[3], maxint[3];
    for (int d = 0; d < 3; d++) minint[d] = static_cast<int>(r.be32());
    for (int d = 0; d < 3; d++) maxint[d] = static_cast<int>(r.be32());
    uint32_t sizeint[3], bitsizeint[3] = {0, 0, 0};
    for (int d = 0; d < 3; d++)
        sizeint[d] = static_cast<uint32_t>(maxint[d] - minint[d] + 1);
    int bitsize;
    if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffffu) {
        for (int d = 0; d < 3; d++) bitsizeint[d] = bits_for(sizeint[d]);
        bitsize = 0;
    } else {
        bitsize = bits_for3(sizeint);
    }
    int smallidx = static_cast<int>(r.be32());
    if (smallidx < FIRSTIDX || smallidx >= LASTIDX) return false;
    int smaller = MAGICINTS[std::max(FIRSTIDX, smallidx - 1)] / 2;
    int smallnum = MAGICINTS[smallidx] / 2;
    uint32_t sizesmall[3];
    sizesmall[0] = sizesmall[1] = sizesmall[2] = MAGICINTS[smallidx];
    uint32_t nbytes = r.be32();
    if (!r.ok || r.pos + nbytes > r.n) return false;
    BitReader br{r.p + r.pos, nbytes};
    r.pos += (nbytes + 3u) & ~3u;  // skip padded opaque

    float inv = 1.0f / prec;
    int i = 0;
    int prevcoord[3] = {0, 0, 0};
    // run persists across atoms: flag==0 on the wire means "same run
    // length as the previous atom" (the encoder's prevrun elision)
    int run = 0;
    float* lfp = x;
    while (i < natoms) {
        int tc[3];
        if (bitsize == 0) {
            tc[0] = static_cast<int>(br.get(bitsizeint[0]));
            tc[1] = static_cast<int>(br.get(bitsizeint[1]));
            tc[2] = static_cast<int>(br.get(bitsizeint[2]));
        } else {
            get_triplet(br, bitsize, sizeint, tc);
        }
        i++;
        for (int d = 0; d < 3; d++) {
            tc[d] += minint[d];
            prevcoord[d] = tc[d];
        }
        int flag = static_cast<int>(br.get(1));
        int is_smaller = 0;
        if (flag == 1) {
            run = static_cast<int>(br.get(5));
            is_smaller = run % 3;
            run -= is_smaller;
            is_smaller--;
        }
        if (run > 0) {
            for (int k = 0; k < run; k += 3) {
                int dc[3];
                get_triplet(br, smallidx, sizesmall, dc);
                i++;
                for (int d = 0; d < 3; d++) dc[d] += prevcoord[d] - smallnum;
                if (k == 0) {
                    // undo the water swap: the run's first entry precedes
                    // the absolute atom in output order
                    for (int d = 0; d < 3; d++) std::swap(dc[d], prevcoord[d]);
                    *lfp++ = prevcoord[0] * inv;
                    *lfp++ = prevcoord[1] * inv;
                    *lfp++ = prevcoord[2] * inv;
                } else {
                    for (int d = 0; d < 3; d++) prevcoord[d] = dc[d];
                }
                *lfp++ = dc[0] * inv;
                *lfp++ = dc[1] * inv;
                *lfp++ = dc[2] * inv;
            }
        } else {
            *lfp++ = tc[0] * inv;
            *lfp++ = tc[1] * inv;
            *lfp++ = tc[2] * inv;
        }
        smallidx += is_smaller;
        if (is_smaller < 0) {
            smallnum = smaller;
            smaller = (smallidx > FIRSTIDX) ? MAGICINTS[smallidx - 1] / 2 : 0;
        } else if (is_smaller > 0) {
            smaller = smallnum;
            smallnum = MAGICINTS[smallidx] / 2;
        }
        sizesmall[0] = sizesmall[1] = sizesmall[2] = MAGICINTS[smallidx];
    }
    return true;
}

// size in bytes of one frame's coordinate block starting at r.pos
// (natoms already known); -1 on error
long coord_block_size(ByteReader r, int natoms) {
    size_t start = r.pos;
    if (natoms <= 9) return 12L * natoms;
    r.pos += 4 + 24;        // precision + min/max
    r.pos += 4;             // smallidx
    uint32_t nbytes = r.be32();
    if (!r.ok) return -1;
    return static_cast<long>(r.pos - start + ((nbytes + 3u) & ~3u));
}

}  // namespace

extern "C" {

// append one frame; returns 0 on success
int xtc_write_frame(const char* path, int natoms, int step, float time,
                    const float* box9, const float* x, float prec) {
    std::vector<unsigned char> out;
    put_be32(out, XTC_MAGIC);
    put_be32(out, static_cast<uint32_t>(natoms));
    put_be32(out, static_cast<uint32_t>(step));
    put_f32(out, time);
    for (int i = 0; i < 9; i++) put_f32(out, box9[i]);
    put_be32(out, static_cast<uint32_t>(natoms));
    if (!compress_coords(out, x, natoms, prec)) return 1;
    FILE* f = std::fopen(path, "ab");
    if (!f) return 2;
    size_t w = std::fwrite(out.data(), 1, out.size(), f);
    std::fclose(f);
    return w == out.size() ? 0 : 3;
}

// count frames and report natoms; returns 0 on success
int xtc_scan(const char* path, int* nframes, int* natoms) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 2;
    std::fseek(f, 0, SEEK_END);
    long total = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<unsigned char> buf(static_cast<size_t>(total));
    if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
        std::fclose(f);
        return 2;
    }
    std::fclose(f);
    ByteReader r{buf.data(), buf.size()};
    int count = 0;
    *natoms = 0;
    while (r.pos + 56 <= r.n) {
        uint32_t magic = r.be32();
        if (magic != XTC_MAGIC) return 4;
        int na = static_cast<int>(r.be32());
        if (*natoms == 0) *natoms = na;
        r.pos += 8 + 36;  // step,time + box
        int na2 = static_cast<int>(r.be32());
        if (na2 != na) return 4;
        long sz = coord_block_size(r, na);
        if (sz < 0) return 4;
        r.pos += static_cast<size_t>(sz);
        if (r.pos > r.n) return 4;
        count++;
    }
    *nframes = count;
    return 0;
}

// read frame by index; x holds cap*3 floats (a frame of more atoms
// returns 6); returns 0 on success
int xtc_read_frame(const char* path, int frame, int cap, float* box9,
                   float* x,
                   int* natoms_out, float* time_out, int* step_out,
                   float* prec_out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 2;
    std::fseek(f, 0, SEEK_END);
    long total = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<unsigned char> buf(static_cast<size_t>(total));
    if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
        std::fclose(f);
        return 2;
    }
    std::fclose(f);
    ByteReader r{buf.data(), buf.size()};
    for (int fi = 0;; fi++) {
        if (r.pos + 56 > r.n) return 5;
        uint32_t magic = r.be32();
        if (magic != XTC_MAGIC) return 4;
        int na = static_cast<int>(r.be32());
        int step = static_cast<int>(r.be32());
        float time = r.f32();
        float box[9];
        for (int i = 0; i < 9; i++) box[i] = r.f32();
        int na2 = static_cast<int>(r.be32());
        if (na2 != na) return 4;
        if (fi == frame) {
            if (na < 0 || na > cap) return 6;
            *natoms_out = na;
            *step_out = step;
            *time_out = time;
            std::memcpy(box9, box, sizeof(box));
            return decompress_coords(r, x, na, prec_out) ? 0 : 4;
        }
        long sz = coord_block_size(r, na);
        if (sz < 0) return 4;
        r.pos += static_cast<size_t>(sz);
    }
}

}  // extern "C"
