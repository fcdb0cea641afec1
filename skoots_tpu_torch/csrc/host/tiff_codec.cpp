// TIFF strip and tile decoders on the host, for the port's own TIFF reader
// (skoots_tpu_torch/utils/tiff.py): LZW (compression 5) and PackBits
// (compression 32773). Deflate is Python's zlib; the predictor, the byte
// order and the layout are numpy. Built by g++ -O3 -shared -fPIC at first
// use (skoots_tpu_torch/utils/host_lib.py); plain C ABI for ctypes; host
// code, not on the device path.

#include <cstdint>
#include <cstring>

extern "C" {

// TIFF LZW (TIFF 6.0 section 13): codes MSB first, 9 to 12 bits wide,
// Clear 256, EndOfInformation 257, the width growing one code early (at
// 511, 1023 and 2047, as libtiff's encoder writes). Each dictionary string
// is a run of bytes already written to ``dst`` -- the previous string
// followed by the first byte of the next -- so an entry is (start, length)
// into the output and a code decodes with one memcpy.
// Writes at most ``cap`` bytes and returns how many it wrote; -1 on a code
// that is not in the dictionary, -2 on the old LSB-first LZW variant.
int64_t tiff_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    if (n >= 2 && src[0] == 0 && (src[1] & 1)) return -2;
    static thread_local int64_t start[4096];
    static thread_local int32_t len[4096];
    int64_t pos = 0, in = 0;
    uint64_t bits = 0;
    int nbits = 0, width = 9, next = 258;
    int64_t prev_start = -1;
    int32_t prev_len = 0;
    while (pos < cap) {
        while (nbits < width && in < n) {
            bits = (bits << 8) | src[in++];
            nbits += 8;
        }
        if (nbits < width) break;
        int code = int((bits >> (nbits - width)) & ((1u << width) - 1));
        nbits -= width;
        if (code == 257) break;
        if (code == 256) {
            width = 9;
            next = 258;
            prev_start = -1;
            continue;
        }
        int64_t s;
        int32_t l;
        if (code < 256) {
            dst[pos] = uint8_t(code);
            s = pos;
            l = 1;
        } else if (code < next && prev_start >= 0) {
            s = pos;
            l = len[code];
            int64_t m = l < cap - pos ? l : cap - pos;
            std::memcpy(dst + pos, dst + start[code], size_t(m));
        } else if (code == next && prev_start >= 0) {  // the KwKwK case
            s = pos;
            l = prev_len + 1;
            int64_t m = prev_len < cap - pos ? prev_len : cap - pos;
            std::memcpy(dst + pos, dst + prev_start, size_t(m));
            if (pos + prev_len < cap) dst[pos + prev_len] = dst[prev_start];
        } else {
            return -1;
        }
        if (prev_start >= 0 && next < 4096) {
            start[next] = prev_start;
            len[next] = prev_len + 1;
            ++next;
            if (next >= (1 << width) - 1 && width < 12) ++width;
        }
        prev_start = s;
        prev_len = l;
        pos += l;
    }
    return pos < cap ? pos : cap;
}

// PackBits (TIFF 6.0 section 9): a header byte h, then h + 1 literal bytes
// (0 <= h <= 127) or one byte repeated 1 - h times (-127 <= h <= -1); -128
// is a no-op. Writes at most ``cap`` bytes and returns how many it wrote.
int64_t tiff_packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    int64_t in = 0, pos = 0;
    while (in < n && pos < cap) {
        int h = int8_t(src[in++]);
        if (h >= 0) {
            int64_t m = h + 1;
            if (m > n - in) m = n - in;
            if (m > cap - pos) m = cap - pos;
            std::memcpy(dst + pos, src + in, size_t(m));
            in += h + 1;
            pos += m;
        } else if (h != -128) {
            if (in >= n) break;
            int64_t m = 1 - h;
            if (m > cap - pos) m = cap - pos;
            std::memset(dst + pos, src[in++], size_t(m));
            pos += m;
        }
    }
    return pos;
}

}  // extern "C"
