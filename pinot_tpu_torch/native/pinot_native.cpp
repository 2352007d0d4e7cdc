// Host helpers of the PyTorch port's on-disk segments, bound with ctypes
// (pinot_tpu_torch/native/__init__.py): the fixed-bit packing of dictIds,
// refcounted read-only file mappings, the CRC-32 of a file, and the
// delta+varint posting lists of the inverted, text and JSON indexes. The
// port's own copy of the JAX package's native/pinot_native.cpp, with one
// addition: pn_varint_decode_lists decodes every posting list of an index
// in one pass at load. Each function has a plain C interface and no
// Python in its loop.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// fixed-bit packing (ref: PinotDataBitSet unaligned bit extraction)
// ---------------------------------------------------------------------------

// packed size in bytes for n values at `bits` bits each (64-bit aligned tail)
int64_t pn_packed_size(int64_t n, int32_t bits) {
    int64_t total_bits = n * (int64_t)bits;
    return ((total_bits + 63) / 64) * 8;
}

// pack int32 values (all < 2^bits) into dst; returns bytes written, -1 on error
int64_t pn_bitpack_i32(const int32_t* src, int64_t n, int32_t bits,
                       uint8_t* dst, int64_t dst_cap) {
    if (bits <= 0 || bits > 32) return -1;
    int64_t need = pn_packed_size(n, bits);
    if (dst_cap < need) return -1;
    std::memset(dst, 0, (size_t)need);
    uint64_t* words = (uint64_t*)dst;
    for (int64_t i = 0; i < n; i++) {
        uint64_t v = (uint32_t)src[i];
        int64_t bit_pos = i * (int64_t)bits;
        int64_t w = bit_pos >> 6;
        int32_t off = (int32_t)(bit_pos & 63);
        words[w] |= v << off;
        if (off + bits > 64) {
            words[w + 1] |= v >> (64 - off);
        }
    }
    return need;
}

// unpack n values of `bits` bits into int32 dst
int64_t pn_bitunpack_i32(const uint8_t* src, int64_t src_len, int64_t n,
                         int32_t bits, int32_t* dst) {
    if (bits <= 0 || bits > 32) return -1;
    if (src_len < pn_packed_size(n, bits)) return -1;
    const uint64_t* words = (const uint64_t*)src;
    uint64_t mask = (bits == 64) ? ~0ULL : ((1ULL << bits) - 1);
    for (int64_t i = 0; i < n; i++) {
        int64_t bit_pos = i * (int64_t)bits;
        int64_t w = bit_pos >> 6;
        int32_t off = (int32_t)(bit_pos & 63);
        uint64_t v = words[w] >> off;
        if (off + bits > 64) {
            v |= words[w + 1] << (64 - off);
        }
        dst[i] = (int32_t)(v & mask);
    }
    return n;
}

// ---------------------------------------------------------------------------
// mmap buffer manager (ref: PinotDataBuffer mapFile/refcount protocol —
// the same acquire/release hazard protocol the HBM staging cache uses)
// ---------------------------------------------------------------------------

struct MappedBuffer {
    void* addr;
    int64_t size;
    int32_t refcount;
};

static std::map<int64_t, MappedBuffer> g_buffers;
static std::mutex g_buffers_mu;
static int64_t g_next_handle = 1;

// map a file read-only; returns handle > 0, or <= 0 on error
int64_t pn_mmap_open(const char* path) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return 0;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return 0; }
    if (st.st_size == 0) { close(fd); return -1; }
    void* addr = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_SHARED,
                      fd, 0);
    close(fd);
    if (addr == MAP_FAILED) return 0;
    std::lock_guard<std::mutex> g(g_buffers_mu);
    int64_t h = g_next_handle++;
    g_buffers[h] = MappedBuffer{addr, (int64_t)st.st_size, 1};
    return h;
}

const void* pn_mmap_addr(int64_t handle) {
    std::lock_guard<std::mutex> g(g_buffers_mu);
    auto it = g_buffers.find(handle);
    return it == g_buffers.end() ? nullptr : it->second.addr;
}

int64_t pn_mmap_size(int64_t handle) {
    std::lock_guard<std::mutex> g(g_buffers_mu);
    auto it = g_buffers.find(handle);
    return it == g_buffers.end() ? -1 : it->second.size;
}

int32_t pn_mmap_acquire(int64_t handle) {
    std::lock_guard<std::mutex> g(g_buffers_mu);
    auto it = g_buffers.find(handle);
    if (it == g_buffers.end() || it->second.refcount <= 0) return 0;
    it->second.refcount++;
    return 1;
}

// returns remaining refcount; unmaps at zero
int32_t pn_mmap_release(int64_t handle) {
    std::lock_guard<std::mutex> g(g_buffers_mu);
    auto it = g_buffers.find(handle);
    if (it == g_buffers.end()) return -1;
    int32_t rc = --it->second.refcount;
    if (rc == 0) {
        munmap(it->second.addr, (size_t)it->second.size);
        g_buffers.erase(it);
    }
    return rc;
}

int64_t pn_mmap_open_count() {
    std::lock_guard<std::mutex> g(g_buffers_mu);
    return (int64_t)g_buffers.size();
}

// ---------------------------------------------------------------------------
// CRC32 (zlib polynomial, table-driven)
// ---------------------------------------------------------------------------

static uint32_t g_crc_table[256];
static bool g_crc_init = false;

static void crc_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        g_crc_table[i] = c;
    }
    g_crc_init = true;
}

uint32_t pn_crc32(const uint8_t* data, int64_t len, uint32_t crc) {
    if (!g_crc_init) crc_init();
    crc = ~crc;
    for (int64_t i = 0; i < len; i++)
        crc = g_crc_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
    return ~crc;
}

// CRC over a whole file without loading it into Python
int64_t pn_crc32_file(const char* path, uint32_t seed) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    uint8_t buf[1 << 16];
    uint32_t crc = seed;
    size_t got;
    while ((got = fread(buf, 1, sizeof(buf), f)) > 0)
        crc = pn_crc32(buf, (int64_t)got, crc);
    fclose(f);
    return (int64_t)crc;
}

// ---------------------------------------------------------------------------
// delta + varint posting lists (sorted doc-id compression, the storage form
// of the inverted index; ref: RoaringBitmap container compression role)
// ---------------------------------------------------------------------------

// encode sorted int32 doc ids; returns bytes written or -1 if dst too small
int64_t pn_varint_encode(const int32_t* src, int64_t n, uint8_t* dst,
                         int64_t dst_cap) {
    int64_t o = 0;
    int32_t prev = 0;
    for (int64_t i = 0; i < n; i++) {
        uint32_t d = (uint32_t)(src[i] - prev);
        prev = src[i];
        while (d >= 0x80) {
            if (o >= dst_cap) return -1;
            dst[o++] = (uint8_t)(d | 0x80);
            d >>= 7;
        }
        if (o >= dst_cap) return -1;
        dst[o++] = (uint8_t)d;
    }
    return o;
}

// encode `num_lists` posting lists in one pass: docs[offsets[i]..offsets[i+1])
// is list i (sorted); delta base resets per list. byte_offsets[num_lists+1]
// receives the per-list byte ranges. Returns total bytes or -1 on overflow.
int64_t pn_varint_encode_lists(const int32_t* docs, const int64_t* offsets,
                               int64_t num_lists, uint8_t* dst,
                               int64_t dst_cap, int64_t* byte_offsets) {
    int64_t o = 0;
    byte_offsets[0] = 0;
    for (int64_t l = 0; l < num_lists; l++) {
        int32_t prev = 0;
        for (int64_t i = offsets[l]; i < offsets[l + 1]; i++) {
            uint32_t d = (uint32_t)(docs[i] - prev);
            prev = docs[i];
            while (d >= 0x80) {
                if (o >= dst_cap) return -1;
                dst[o++] = (uint8_t)(d | 0x80);
                d >>= 7;
            }
            if (o >= dst_cap) return -1;
            dst[o++] = (uint8_t)d;
        }
        byte_offsets[l + 1] = o;
    }
    return o;
}

int64_t pn_varint_decode(const uint8_t* src, int64_t len, int32_t* dst,
                         int64_t n) {
    int64_t o = 0;
    int32_t prev = 0;
    for (int64_t i = 0; i < n; i++) {
        uint32_t d = 0;
        int shift = 0;
        while (true) {
            if (o >= len) return -1;
            uint8_t b = src[o++];
            d |= (uint32_t)(b & 0x7F) << shift;
            if (!(b & 0x80)) break;
            shift += 7;
        }
        prev += (int32_t)d;
        dst[i] = prev;
    }
    return n;
}

// decode `num_lists` posting lists in one pass: list l's bytes are
// src[byte_offsets[l]..byte_offsets[l+1]) and its doc count
// offsets[l+1] - offsets[l]; its ids land at dst[offsets[l]..). The delta
// base resets per list. Returns the ids written or -1 on a malformed list.
int64_t pn_varint_decode_lists(const uint8_t* src, int64_t len,
                               const int64_t* byte_offsets,
                               const int64_t* offsets, int64_t num_lists,
                               int32_t* dst) {
    for (int64_t l = 0; l < num_lists; l++) {
        int64_t lo = byte_offsets[l], hi = byte_offsets[l + 1];
        if (lo < 0 || hi > len || lo > hi) return -1;
        int64_t n = offsets[l + 1] - offsets[l];
        if (n < 0) return -1;
        if (n == 0) continue;
        if (pn_varint_decode(src + lo, hi - lo, dst + offsets[l], n) != n)
            return -1;
    }
    return num_lists ? offsets[num_lists] - offsets[0] : 0;
}

}  // extern "C"
