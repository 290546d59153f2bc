/* zng_host.c — native host-runtime kernels for zlibng_tpu_torch.
 *
 * A copy of zlibng_tpu/native/zng_host.c (the tests hold the two builds to
 * the same results): the format-serial paths that stay on the CPU
 * (conformance inflate hot loop, framing checksums, host Huffman builds)
 * while the card runs the batch codec. Built at first use by
 * zlibng_tpu_torch/native/__init__.py (ctypes bindings; every caller has a
 * numpy route when no C compiler is found).
 *
 * Components (reference parity cites):
 *   zng_adler32     — adler32_p.h:54-73 NMAX-blocked accumulation
 *   zng_crc32       — crc32_braid_c.c-style ILP (slicing-by-8 tables,
 *                     generated at runtime like tools/makecrct.c)
 *   zng_decode_huff — the inffast_tpl.h:53-298 analog over the flat
 *                     15-bit LUT layout of huffman/decode_tables.py:
 *                     64-bit refill, one table load per symbol,
 *                     overlap-tolerant LZ77 copies
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <pthread.h>

#define ADLER_BASE 65521u
#define ADLER_NMAX 5552

/* Dot-product formulation (the adler32_avx2.c:21-60 idea): over a block
 * of k bytes, s2 += k*s1 + sum((k-i)*b[i]); s1 += sum(b). The weighted sum
 * decomposes per 32-byte chunk q as 32*(chunks-1-q)*chunksum_q +
 * dot(chunk, [32..1]), which maps onto SAD (chunk sums) and MADDUBS
 * (constant-weight dot). NMAX blocking keeps everything in uint32 exactly
 * as in adler32_p.h:11-13. */
#ifdef __AVX2__
#include <immintrin.h>

static void zng_adler_blk_avx2(const uint8_t *buf, long k, uint32_t *s1io,
                               uint32_t *s2io) {
    /* k is a multiple of 32, k <= NMAX */
    const __m256i zero = _mm256_setzero_si256();
    const __m256i wts = _mm256_setr_epi8(
        32, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17,
        16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1);
    const __m256i ones16 = _mm256_set1_epi16(1);
    __m256i vs1 = zero;     /* u64 x4: running chunk sums (via SAD)   */
    __m256i vsum2 = zero;   /* u64 x4: sum of vs1 snapshots per chunk */
    __m256i vdot = zero;    /* i32 x8: per-chunk weighted dots        */
    for (long j = 0; j < k; j += 32) {
        __m256i c = _mm256_loadu_si256((const __m256i *)(buf + j));
        vsum2 = _mm256_add_epi64(vsum2, vs1);
        vs1 = _mm256_add_epi64(vs1, _mm256_sad_epu8(c, zero));
        __m256i m = _mm256_maddubs_epi16(c, wts);        /* u8*i8 -> i16 */
        vdot = _mm256_add_epi32(vdot, _mm256_madd_epi16(m, ones16));
    }
    uint64_t l1[4], l2[4];
    uint32_t ld[8];
    _mm256_storeu_si256((__m256i *)l1, vs1);
    _mm256_storeu_si256((__m256i *)l2, vsum2);
    _mm256_storeu_si256((__m256i *)ld, vdot);
    uint32_t sum = (uint32_t)(l1[0] + l1[1] + l1[2] + l1[3]);
    uint32_t sum2 = (uint32_t)(l2[0] + l2[1] + l2[2] + l2[3]);
    uint32_t dot = ld[0] + ld[1] + ld[2] + ld[3] + ld[4] + ld[5] + ld[6]
                   + ld[7];
    uint32_t s1 = *s1io, s2 = *s2io;
    s2 = (s2 + (uint32_t)k * s1 + 32u * sum2 + dot) % ADLER_BASE;
    s1 = (s1 + sum) % ADLER_BASE;
    *s1io = s1;
    *s2io = s2;
}
#endif

uint32_t zng_adler32(const uint8_t *buf, long n, uint32_t adler) {
    uint32_t s1 = adler & 0xFFFF;
    uint32_t s2 = (adler >> 16) & 0xFFFF;
#ifdef __AVX2__
    while (n >= 32) {
        long k = n < ADLER_NMAX ? n : ADLER_NMAX;
        k &= ~31L;
        zng_adler_blk_avx2(buf, k, &s1, &s2);
        buf += k;
        n -= k;
    }
#endif
    while (n > 0) {
        long k = n < ADLER_NMAX ? n : ADLER_NMAX;
        n -= k;
        while (k--) { s1 += *buf++; s2 += s1; }
        s1 %= ADLER_BASE;
        s2 %= ADLER_BASE;
    }
    /* zlib reduces the seed even for len==0 (adler32.c len<16 path) */
    s1 %= ADLER_BASE;
    s2 %= ADLER_BASE;
    return (s2 << 16) | s1;
}

/* ---- CRC-32 (gzip polynomial 0xEDB88320), slicing-by-8 ---- */
static uint32_t crc_tab[8][256];
static int crc_ready = 0;
static pthread_once_t crc_once = PTHREAD_ONCE_INIT;

#if defined(__PCLMUL__) && defined(__SSE4_1__)
static void zng_pclmul_setup(void);   /* defined with the PCLMUL kernels */
#endif

/* All CRC setup — slicing tables, PCLMUL fold constants, and the PCLMUL
 * selftest — runs once under pthread_once. ctypes releases the GIL during
 * zng_crc32, so lazy per-call init of the fold constants was a data race
 * on K512/K128/pclmul_state (advisor round 3, low). */
static void zng_crc_init_impl(void) {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c >> 1) ^ (0xEDB88320u & (0u - (c & 1)));
        crc_tab[0][i] = c;
    }
    for (int t = 1; t < 8; t++)
        for (uint32_t i = 0; i < 256; i++)
            crc_tab[t][i] = (crc_tab[t - 1][i] >> 8)
                            ^ crc_tab[0][crc_tab[t - 1][i] & 0xFF];
    crc_ready = 1;   /* before pclmul_setup: its selftest calls crc32_s8 */
#if defined(__PCLMUL__) && defined(__SSE4_1__)
    zng_pclmul_setup();
#endif
}

void zng_crc_init(void) {
    pthread_once(&crc_once, zng_crc_init_impl);
}

static uint32_t zng_crc32_s8(const uint8_t *buf, long n, uint32_t crc) {
    if (!crc_ready) zng_crc_init();
    crc = ~crc;
    while (n && ((uintptr_t)buf & 7)) {
        crc = (crc >> 8) ^ crc_tab[0][(crc ^ *buf++) & 0xFF];
        n--;
    }
    while (n >= 8) {
        uint64_t w;
        memcpy(&w, buf, 8);
        w ^= crc;
        crc = crc_tab[7][w & 0xFF] ^ crc_tab[6][(w >> 8) & 0xFF]
            ^ crc_tab[5][(w >> 16) & 0xFF] ^ crc_tab[4][(w >> 24) & 0xFF]
            ^ crc_tab[3][(w >> 32) & 0xFF] ^ crc_tab[2][(w >> 40) & 0xFF]
            ^ crc_tab[1][(w >> 48) & 0xFF] ^ crc_tab[0][(w >> 56) & 0xFF];
        buf += 8; n -= 8;
    }
    while (n--) crc = (crc >> 8) ^ crc_tab[0][(crc ^ *buf++) & 0xFF];
    return ~crc;
}

/* ---- CRC-32 via carry-less multiply folding (crc32_pclmulqdq_tpl.h:40-70
 * concept: fold 64 input bytes per iteration through x^512 multiples).
 * The fold constants are GENERATED at init from the polynomial with plain
 * GF(2) arithmetic (x^n mod P, mirroring tools/makecrct.c's
 * generate-don't-transcribe ethos), and the engine self-tests against the
 * table implementation before being selected — a wrong constant can never
 * ship a wrong checksum. */
#if defined(__PCLMUL__) && defined(__SSE4_1__)
#include <wmmintrin.h>
#include <smmintrin.h>

/* x^(n) mod P (bit-reflected convention): constants for the reflected
 * fold are bitrev33(x^(n) mod P) = computed directly in the reflected
 * domain: r' = (r >> 1) ^ (P_reflected & -(r & 1)) steps x -> x^2... Use
 * the forward domain and reflect at the end. */
static uint64_t zng_xnmodp(long n) {         /* forward: x^n mod P, P 33-bit */
    const uint64_t poly = 0x104C11DB7ULL;    /* forward CRC-32 polynomial */
    uint64_t r = 1;                          /* x^0 */
    while (n--) {
        int hi = (r >> 31) & 1;
        r = (r << 1) & 0xFFFFFFFFULL;
        if (hi) r ^= (poly & 0xFFFFFFFFULL);
    }
    return r;
}

static uint64_t zng_brev33(uint64_t x, int width) {
    uint64_t r = 0;
    for (int i = 0; i < width; i++)
        if ((x >> i) & 1) r |= 1ULL << (width - 1 - i);
    return r;
}

/* reflected-domain fold constant for shifting data m bits forward,
 * UNREDUCED: K(m) = brev32(x^(m+32) mod P) << 1 — the +32 embeds the CRC
 * state register, the <<1 compensates clmul's reversed bit order. The
 * callers below pass m+32 directly. Verified empirically against the
 * byte-serial recurrence (and the published Intel constants: K(512+32) =
 * 0x154442bd4 etc). */
static uint64_t zng_kconst(long n) {
    return zng_brev33(zng_xnmodp(n), 32) << 1;
}

static __m128i K512, K128;           /* 512/128-bit-shift fold constants */
static int pclmul_state = 0;         /* 0 untested, 1 ok, -1 unusable */

__attribute__((target("pclmul,sse4.1")))
static void zng_pclmul_init_consts(void) {
    /* a qword m BYTES before its fold target uses K(8m): low qword of a
     * 16-byte lane is 8 lanes x 8 bytes = 64 bytes back -> K(512), the
     * high qword 56 bytes -> K(448); for the 4->1 lane folds 16/8 bytes
     * -> K(128)/K(64) */
    K512 = _mm_set_epi64x((long long)zng_kconst(448 + 32),
                          (long long)zng_kconst(512 + 32));
    K128 = _mm_set_epi64x((long long)zng_kconst(64 + 32),
                          (long long)zng_kconst(128 + 32));
}

__attribute__((target("pclmul,sse4.1")))
static uint32_t zng_crc32_clmul(const uint8_t *buf, long n, uint32_t crc) {
    __m128i x0, x1, x2, x3;
    x0 = _mm_loadu_si128((const __m128i *)(buf + 0));
    x1 = _mm_loadu_si128((const __m128i *)(buf + 16));
    x2 = _mm_loadu_si128((const __m128i *)(buf + 32));
    x3 = _mm_loadu_si128((const __m128i *)(buf + 48));
    x0 = _mm_xor_si128(x0, _mm_cvtsi32_si128((int)~crc));
    buf += 64; n -= 64;
    while (n >= 64) {
        __m128i y0 = _mm_loadu_si128((const __m128i *)(buf + 0));
        __m128i y1 = _mm_loadu_si128((const __m128i *)(buf + 16));
        __m128i y2 = _mm_loadu_si128((const __m128i *)(buf + 32));
        __m128i y3 = _mm_loadu_si128((const __m128i *)(buf + 48));
        x0 = _mm_xor_si128(_mm_xor_si128(
                 _mm_clmulepi64_si128(x0, K512, 0x00),
                 _mm_clmulepi64_si128(x0, K512, 0x11)), y0);
        x1 = _mm_xor_si128(_mm_xor_si128(
                 _mm_clmulepi64_si128(x1, K512, 0x00),
                 _mm_clmulepi64_si128(x1, K512, 0x11)), y1);
        x2 = _mm_xor_si128(_mm_xor_si128(
                 _mm_clmulepi64_si128(x2, K512, 0x00),
                 _mm_clmulepi64_si128(x2, K512, 0x11)), y2);
        x3 = _mm_xor_si128(_mm_xor_si128(
                 _mm_clmulepi64_si128(x3, K512, 0x00),
                 _mm_clmulepi64_si128(x3, K512, 0x11)), y3);
        buf += 64; n -= 64;
    }
    /* fold 4 lanes -> 1 (shift by 128 bits each) */
    x1 = _mm_xor_si128(_mm_xor_si128(
             _mm_clmulepi64_si128(x0, K128, 0x00),
             _mm_clmulepi64_si128(x0, K128, 0x11)), x1);
    x2 = _mm_xor_si128(_mm_xor_si128(
             _mm_clmulepi64_si128(x1, K128, 0x00),
             _mm_clmulepi64_si128(x1, K128, 0x11)), x2);
    x3 = _mm_xor_si128(_mm_xor_si128(
             _mm_clmulepi64_si128(x2, K128, 0x00),
             _mm_clmulepi64_si128(x2, K128, 0x11)), x3);
    /* every fold preserves walk-equivalence with MATCHED byte counts
     * (an unreduced product spans <= 13 bytes, always inside the folded
     * target), so the final lane is simply a 16-byte stream whose
     * byte-serial walk equals the whole prefix's — finish with 16 table
     * steps plus the tail. No Barrett reduction needed. */
    uint8_t rem[16];
    _mm_storeu_si128((__m128i *)rem, x3);
    uint32_t c = 0;
    for (int k = 0; k < 16; k++)
        c = (c >> 8) ^ crc_tab[0][(c ^ rem[k]) & 0xFF];
    while (n--) c = (c >> 8) ^ crc_tab[0][(c ^ *buf++) & 0xFF];
    return ~c;
}

__attribute__((target("pclmul,sse4.1")))
static int zng_pclmul_selftest(void) {
    uint8_t v[257];
    for (int i = 0; i < 257; i++) v[i] = (uint8_t)(i * 131 + 7);
    for (long len = 64; len <= 257; len += 63) {
        uint32_t a = zng_crc32_s8(v, len, 0);
        uint32_t b = zng_crc32_clmul(v, len, 0);
        if (a != b) return 0;
    }
    return 1;
}

/* Called once from zng_crc_init_impl (under pthread_once). */
static void zng_pclmul_setup(void) {
    zng_pclmul_init_consts();
    pclmul_state = zng_pclmul_selftest() ? 1 : -1;
}
#endif

uint32_t zng_crc32(const uint8_t *buf, long n, uint32_t crc) {
    if (!crc_ready) zng_crc_init();
#if defined(__PCLMUL__) && defined(__SSE4_1__)
    if (n >= 128 && pclmul_state == 1)
        return zng_crc32_clmul(buf, n, crc);
#endif
    return zng_crc32_s8(buf, n, crc);
}

/* ---- canonical-code flat LUT fill (inftrees.c table build analog) ----
 * lengths[nsyms] per-symbol code lengths (0 = unused); fills lut[2^max_len]
 * with packed sym<<4|len entries (invalid peeks stay negative). The caller
 * validates the length set first (Kraft accounting stays in Python, where
 * the acceptance rules of inftrees.c:122-130 are implemented). */
void zng_fill_lut(const int32_t *lengths, long nsyms, int max_len,
                  int32_t *lut) {
    long size = 1L << max_len;
    for (long i = 0; i < size; i++) lut[i] = -16;
    long bl_count[16] = {0};
    for (long s = 0; s < nsyms; s++)
        if (lengths[s] > 0) bl_count[lengths[s]]++;
    uint32_t next_code[16];
    uint32_t code = 0;
    for (int b = 1; b <= 15; b++) {
        code = (uint32_t)((code + bl_count[b - 1]) << 1);
        next_code[b] = code;
    }
    for (long s = 0; s < nsyms; s++) {
        int l = lengths[s];
        if (l <= 0) continue;
        uint32_t c = next_code[l]++;
        uint32_t r = 0;
        for (int k = 0; k < l; k++) r |= ((c >> k) & 1u) << (l - 1 - k);
        long stride = 1L << l;
        int32_t ent = (int32_t)((s << 4) | l);
        for (long idx = (long)r; idx < size; idx += stride) lut[idx] = ent;
    }
}

/* ---- dynamic block header parse (inflate.c:801-922 TABLE..CODELENS) ----
 *
 * Parses HLIT/HDIST/HCLEN, the code-length code, and the RLE-coded
 * lit/dist code lengths starting at *bitpos_io (LSB-first). On success
 * returns 0, writes hlit+hdist entries into lengths_out (caller provides
 * >= 316 int32), sets *hlit_io/*hdist_io and advances *bitpos_io. Returns
 * 1 when more input is needed (*bitpos_io unchanged; same conservative
 * per-symbol 14-bit lookahead rule as the Python parser). On success also
 * validates both code sets (inftrees.c:98-130 acceptance rules) and fills
 * the caller's 32768-entry lit/dist LUTs. Corrupt data:
 *   -1  too many length or distance symbols
 *   -6  invalid code lengths set (bad Kraft / invalid CL symbol)
 *   -7  invalid bit length repeat
 *   -8  invalid code -- missing end-of-block
 *   -9  invalid literal/lengths set
 *   -10 invalid distances set
 */
static const uint8_t BL_ORD[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,2,
                                   14,1,15};

static uint64_t zng_peek(const uint8_t *data, long nbytes, long bp, int n) {
    uint64_t hold;
    long byte = bp >> 3;
    long av = nbytes - byte;
    if (av >= 8) {
        memcpy(&hold, data + byte, 8);
    } else {
        hold = 0;
        for (long k = 0; k < av; k++)
            hold |= (uint64_t)data[byte + k] << (8 * k);
    }
    return (hold >> (bp & 7)) & ((1ull << n) - 1ull);
}

/* Kraft accounting (validate_lengths analog): 0 ok (incl. zero used
 * symbols -> error-forcing table), -1 oversubscribed, -2 unacceptably
 * incomplete. kind: 0 CODES, 1 LENS, 2 DISTS. */
static int zng_validate(const int32_t *lengths, long nsyms, int kind) {
    long bl[16] = {0};
    long nused = 0;
    int maxu = 0;
    for (long s = 0; s < nsyms; s++)
        if (lengths[s] > 0) {
            bl[lengths[s]]++;
            nused++;
            if (lengths[s] > maxu) maxu = (int)lengths[s];
        }
    if (nused == 0) return 0;
    long left = 1;
    for (int b = 1; b <= 15; b++) {
        left <<= 1;
        left -= bl[b];
        if (left < 0) return -1;
    }
    if (left > 0 && (kind == 0 || maxu != 1)) return -2;
    return 0;
}

static int zng_max_len(const int32_t *lengths, long nsyms) {
    int m = 1;
    for (long s = 0; s < nsyms; s++)
        if (lengths[s] > m) m = (int)lengths[s];
    return m;
}

static long zng_parse_dyn_lengths(const uint8_t *data, long nbytes,
                                  long *bitpos_io, int32_t *lengths_out,
                                  long *hlit_io, long *hdist_io) {
    long bp = *bitpos_io;
    const long total = nbytes * 8;
    if (total - bp < 14) return 1;
    long hlit = (long)zng_peek(data, nbytes, bp, 5) + 257; bp += 5;
    long hdist = (long)zng_peek(data, nbytes, bp, 5) + 1;  bp += 5;
    long hclen = (long)zng_peek(data, nbytes, bp, 4) + 4;  bp += 4;
    if (hlit > 286 || hdist > 30) return -1;
    if (total - bp < 3 * hclen) return 1;

    int32_t cl_len[19];
    for (int i = 0; i < 19; i++) cl_len[i] = 0;
    for (long i = 0; i < hclen; i++) {
        cl_len[BL_ORD[i]] = (int32_t)zng_peek(data, nbytes, bp, 3);
        bp += 3;
    }
    /* Kraft accounting; CODES-kind sets must be complete
     * (inftrees.c:98-130 acceptance rules; all-zero also rejects here,
     * matching the error-forcing-table-then-first-lookup Python path) */
    long bl_count[8] = {0};
    long nused = 0;
    for (int s = 0; s < 19; s++)
        if (cl_len[s] > 0) { bl_count[cl_len[s]]++; nused++; }
    if (nused == 0) return -6;
    long left = 1;
    for (int b = 1; b <= 7; b++) {
        left <<= 1;
        left -= bl_count[b];
        if (left < 0) return -6;
    }
    if (left > 0) return -6;

    int32_t cl_lut[128];
    zng_fill_lut(cl_len, 19, 7, cl_lut);

    long n = 0;
    const long nsym = hlit + hdist;
    while (n < nsym) {
        if (total - bp < 14) return 1;    /* 7-bit code + <=7 extra */
        int32_t ent = cl_lut[zng_peek(data, nbytes, bp, 7)];
        if (ent < 0) return -6;
        long sym = ent >> 4;
        bp += ent & 15;
        if (sym < 16) {
            lengths_out[n++] = (int32_t)sym;
        } else if (sym == 16) {
            if (n == 0) return -7;
            long rep = 3 + (long)zng_peek(data, nbytes, bp, 2); bp += 2;
            if (n + rep > nsym) return -7;
            int32_t v = lengths_out[n - 1];
            while (rep--) lengths_out[n++] = v;
        } else if (sym == 17) {
            long rep = 3 + (long)zng_peek(data, nbytes, bp, 3); bp += 3;
            if (n + rep > nsym) return -7;
            while (rep--) lengths_out[n++] = 0;
        } else {
            long rep = 11 + (long)zng_peek(data, nbytes, bp, 7); bp += 7;
            if (n + rep > nsym) return -7;
            while (rep--) lengths_out[n++] = 0;
        }
    }
    if (lengths_out[256] == 0) return -8;
    if (zng_validate(lengths_out, hlit, 1)) return -9;
    if (zng_validate(lengths_out + hlit, hdist, 2)) return -10;
    *bitpos_io = bp;
    *hlit_io = hlit;
    *hdist_io = hdist;
    return 0;
}

long zng_read_dyn_header(const uint8_t *data, long nbytes, long *bitpos_io,
                         int32_t *lengths_out, long *hlit_io,
                         long *hdist_io, int32_t *lit_lut,
                         int32_t *dist_lut, int32_t *lut_bits_io) {
    long ret = zng_parse_dyn_lengths(data, nbytes, bitpos_io, lengths_out,
                                     hlit_io, hdist_io);
    if (ret) return ret;
    long hlit = *hlit_io, hdist = *hdist_io;
    /* variable-width flat LUTs: fill only 2^maxlen entries (the analog of
     * inftrees.c sizing root tables by the actual code-length profile);
     * the decode loop masks its peek by the table width */
    int lit_bits = zng_max_len(lengths_out, hlit);
    int dist_bits = zng_max_len(lengths_out + hlit, hdist);
    zng_fill_lut(lengths_out, hlit, lit_bits, lit_lut);
    zng_fill_lut(lengths_out + hlit, hdist, dist_bits, dist_lut);
    lut_bits_io[0] = lit_bits;
    lut_bits_io[1] = dist_bits;
    return 0;
}

/* ---- Huffman-block decode hot loop ----
 *
 * data/nbytes: the whole input buffer; *bitpos_io: LSB-first bit cursor.
 * lit_lut/dist_lut: 32768-entry int32 packed (sym<<4 | nbits), negative
 *   = invalid peek (layout from huffman/decode_tables.build_decode_lut).
 * out/out_cap/*out_len_io: output buffer holding all history produced so
 *   far (including any dictionary prefix); LZ77 copies read from it.
 * wsize: window size for the distance check (inflate strict semantics of
 *   stream/inflate_serial.py).
 *
 * Returns: 0 EOB, 1 need more input (cursor at last symbol boundary),
 *   2 output buffer full (caller grows and re-calls), -2 invalid
 *   literal/length code, -3 invalid distance code, -4 invalid distance
 *   too far back, -5 unexpected end of stream (finish set).
 */
static const uint16_t LB[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,35,
                                43,51,59,67,83,99,115,131,163,195,227,258};
static const uint8_t  LE[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,3,3,3,3,4,4,
                                4,4,5,5,5,5,0};
static const uint32_t DB[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,193,
                                257,385,513,769,1025,1537,2049,3073,4097,
                                6145,8193,12289,16385,24577};
static const uint8_t  DE[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,7,7,8,8,9,9,
                                10,10,11,11,12,12,13,13};

long zng_decode_huff(const uint8_t *data, long nbytes, long *bitpos_io,
                     const int32_t *lit_lut, const int32_t *dist_lut,
                     uint8_t *out, long out_cap, long *out_len_io,
                     long wsize, int finish, long *ncodes_io,
                     int lit_bits, int dist_bits) {
    long bp = *bitpos_io;
    long olen = *out_len_io;
    long ncodes = 0;
    const long total_bits = nbytes * 8;
    const uint32_t lmask = (1u << lit_bits) - 1u;
    const uint32_t dmask = (1u << dist_bits) - 1u;
    long ret;

    /* Fast path (inffast_tpl.h:53-298 analog): while a full 56-bit hold is
     * loadable and a max-length match fits the output, decode without
     * per-component bounds checks — one unaligned load covers up to three
     * literals (3x15 bits) or a whole match (15+5+15+13 bits). Any symbol
     * that needs care (EOB, errors, buffer edges) drops to the careful
     * loop below, which re-decodes it with full checking. */
    while (total_bits - bp >= 64 && olen + 258 <= out_cap) {
        uint64_t hold;
        memcpy(&hold, data + (bp >> 3), 8);
        hold >>= (bp & 7);
        int32_t ent = lit_lut[hold & lmask];
        if (ent < 0) break;                      /* careful loop: ret -2 */
        long nb = ent & 15;
        long sym = ent >> 4;
        hold >>= nb;
        long used = nb;
        if (sym < 256) {
            out[olen++] = (uint8_t)sym;
            ncodes++;
            ent = lit_lut[hold & lmask];
            if (ent >= 0 && (ent >> 4) < 256) {  /* second literal */
                out[olen++] = (uint8_t)(ent >> 4);
                ncodes++;
                nb = ent & 15;
                hold >>= nb;
                used += nb;
                ent = lit_lut[hold & lmask];
                if (ent >= 0 && (ent >> 4) < 256) {  /* third literal */
                    out[olen++] = (uint8_t)(ent >> 4);
                    ncodes++;
                    used += ent & 15;
                }
            }
            bp += used;
            continue;
        }
        if (sym >= 256 && sym <= 285 && sym != 256) {
            long i = sym - 257;
            long e = LE[i];
            long length = LB[i] + (long)(hold & ((1u << e) - 1));
            hold >>= e;
            used += e;
            int32_t dent = dist_lut[hold & dmask];
            long dsym = dent >> 4;
            if (dent < 0 || dsym > 29) break;    /* careful loop: ret -3 */
            long dnb = dent & 15;
            hold >>= dnb;
            used += dnb;
            e = DE[dsym];
            long dist = DB[dsym] + (long)(hold & ((1u << e) - 1));
            used += e;
            if (dist > olen || dist > wsize) break;  /* careful: ret -4 */
            bp += used;
            ncodes++;
            uint8_t *dst = out + olen;
            const uint8_t *src = dst - dist;
            if (dist >= 8 && dist >= length) {
                memcpy(dst, src, (size_t)length);
            } else {
                for (long k = 0; k < length; k++) dst[k] = src[k];
            }
            olen += length;
            continue;
        }
        break;                       /* EOB or invalid: careful loop */
    }

    /* Careful tail loop: decodes right up to the last available bit —
     * every component rolls back to the symbol start and returns 1 when
     * bits run out, so streaming callers see end-of-stream (and trailers)
     * as soon as the final block's EOB is decodable, like zlib. */
    for (;;) {
        /* 56-bit refill (inffast_tpl.h:142-147 analog) */
        uint64_t hold;
        long byte = bp >> 3;
        long av = nbytes - byte;
        if (av >= 8) {
            memcpy(&hold, data + byte, 8);
        } else {
            hold = 0;
            for (long k = 0; k < av; k++)
                hold |= (uint64_t)data[byte + k] << (8 * k);
        }
        hold >>= (bp & 7);

        int32_t ent = lit_lut[hold & lmask];
        if (ent < 0) {
            if (bp + 15 > total_bits && !finish) { ret = 1; break; }
            ret = -2; break;
        }
        long nb = ent & 15;
        long sym = ent >> 4;
        bp += nb;
        if (bp > total_bits) {
            if (finish) { ret = -5; break; }
            bp -= nb; ret = 1; break;
        }
        ncodes++;
        if (sym < 256) {
            if (olen >= out_cap) { bp -= nb; ncodes--; ret = 2; break; }
            out[olen++] = (uint8_t)sym;
            continue;
        }
        if (sym == 256) { ret = 0; break; }
        if (sym > 285) { ret = -2; break; }
        hold >>= nb;
        long used = nb;
        long i = sym - 257;
        long e = LE[i];
        long length = LB[i] + (long)(hold & ((1u << e) - 1));
        hold >>= e; used += e; bp += e;

        int32_t dent = dist_lut[hold & dmask];
        long dsym = dent >> 4;
        if (dent < 0 || dsym > 29) {
            /* NEED_INPUT rollback un-counts the symbol (it will be decoded
             * again); the error path keeps it counted, matching the Python
             * hot loop's codes_used bookkeeping exactly */
            if (bp + 15 > total_bits && !finish) {
                bp -= used; ncodes--; ret = 1; break;
            }
            ret = -3; break;
        }
        long dnb = dent & 15;
        hold >>= dnb; used += dnb; bp += dnb;
        e = DE[dsym];
        long dist = DB[dsym] + (long)(hold & ((1u << e) - 1));
        used += e; bp += e;
        if (bp > total_bits) {
            if (finish) { ret = -5; break; }
            bp -= used; ncodes--; ret = 1; break;
        }
        if (dist > olen || dist > wsize) { ret = -4; break; }
        if (olen + length > out_cap) { bp -= used; ncodes--; ret = 2; break; }
        /* overlap-tolerant copy (chunkset CHUNKCOPY semantics) */
        {
            uint8_t *dst = out + olen;
            const uint8_t *src = dst - dist;
            if (dist >= 8 && dist >= length) {
                memcpy(dst, src, (size_t)length);
            } else {
                for (long k = 0; k < length; k++) dst[k] = src[k];
            }
            olen += length;
        }
    }
    *bitpos_io = bp;
    *out_len_io = olen;
    *ncodes_io += ncodes;
    return ret;
}

/* ======================================================================
 * Whole-stream native inflate (raw DEFLATE block loop on the host).
 *
 * The per-block entry points above stay as-is — they are the seam the
 * TPU batch decoder (ops/inflate_tpu.py) and the Z_BLOCK/Z_TREES stop
 * paths consume (flat variable-width LUTs). This section is the host
 * throughput path: a self-contained block loop using two-level
 * root+sub decode tables (inftrees.c:30-295 root-bits idea): the root
 * table is <= 2^10 entries = 4 KiB, so it stays L1-resident, where the
 * 15-bit flat LUT (128 KiB) thrashes L2 on every symbol.
 *
 * Table entry format (int32). Valid entries are "decode-ready": length and
 * distance base/extra live inside the entry (the reference's code
 * {op,bits,val} triple, inftrees.h:14-39, flattened), so the hot loop
 * never touches the LB/LE/DB/DE side tables and never range-checks syms:
 *   lit/len table, ent >= 0:
 *     [0:4]  code length (bits to consume)
 *     [4:6]  kind: 0 literal, 1 end-of-block, 2 length, 3 invalid sym
 *     [6:14] literal byte (kind 0) or match-length base - 3 (kind 2)
 *     [14:18] length extra bits (kind 2)
 *   dist table, ent >= 0:
 *     [0:4]  code length
 *     [4:19] distance base - 1
 *     [19:23] distance extra bits (15 = invalid symbol 30/31)
 *   either table, ent < 0:
 *     ent == -16      invalid peek
 *     ent <= -32      sub-pointer: s = -ent - 32; sub table at
 *                     tbl[(1<<root) + (s>>4)], indexed by the next (s&15)
 *                     bits; sub entries are direct or -16.
 * ====================================================================== */

static uint32_t zng_bitrev(uint32_t c, int l) {
    uint32_t r = 0;
    for (int k = 0; k < l; k++) r |= ((c >> k) & 1u) << (l - 1 - k);
    return r;
}

/* Decode-ready entry for symbol s with code length l (layouts above). */
static inline int32_t zng_tbl2_ent(long s, int l, int is_dist) {
    if (is_dist) {
        if (s > 29)
            return (int32_t)(l | (15 << 19));
        return (int32_t)(l | (long)(DB[s] - 1) << 4 | (long)DE[s] << 19);
    }
    if (s < 256)
        return (int32_t)(l | (s << 6));
    if (s == 256)
        return (int32_t)(l | (1 << 4));
    if (s <= 285)
        return (int32_t)(l | (2 << 4) | (long)(LB[s - 257] - 3) << 6
                         | (long)LE[s - 257] << 14);
    return (int32_t)(l | (3 << 4));
}

/* Build a two-level table. root_req <= 10. Returns entries used, or -1 if
 * tbl_cap would overflow (cannot happen for Kraft-valid code sets with the
 * caller's caps; checked anyway so hostile inputs cannot scribble).
 * Writes the actual root width (shrunk to maxlen) to *root_io. */
static long zng_build_tbl2(const int32_t *lengths, long nsyms, int root_req,
                           int32_t *tbl, long tbl_cap, int *root_io,
                           int is_dist) {
    long bl[16] = {0};
    int maxlen = 0;
    long nused = 0;
    for (long s = 0; s < nsyms; s++) {
        int l = lengths[s];
        if (l > 0) {
            bl[l]++;
            nused++;
            if (l > maxlen) maxlen = l;
        }
    }
    int root = root_req > 12 ? 12 : root_req;
    if (maxlen > 0 && maxlen < root) root = maxlen;
    long rsize = 1L << root;
    if (rsize > tbl_cap) return -1;
    for (long i = 0; i < rsize; i++) tbl[i] = -16;
    *root_io = root;
    if (nused == 0) return rsize;

    uint32_t next_code[16];
    uint32_t code = 0;
    for (int b = 1; b <= 15; b++) {
        code = (uint32_t)((code + bl[b - 1]) << 1);
        next_code[b] = code;
    }
    long used = rsize;
    int8_t need[1 << 12];
    int32_t sub_base[1 << 12];
    if (maxlen > root) {
        memset(need, 0, (size_t)rsize);
        uint32_t nc2[16];
        memcpy(nc2, next_code, sizeof nc2);
        for (long s = 0; s < nsyms; s++) {
            int l = lengths[s];
            if (l <= root) {
                if (l > 0) nc2[l]++;
                continue;
            }
            uint32_t c = nc2[l]++;
            long ridx = (long)zng_bitrev(c >> (l - root), root);
            if (l - root > need[ridx]) need[ridx] = (int8_t)(l - root);
        }
        for (long r = 0; r < rsize; r++) {
            if (!need[r]) continue;
            long size = 1L << need[r];
            if (used + size > tbl_cap) return -1;
            for (long i = 0; i < size; i++) tbl[used + i] = -16;
            tbl[r] = -(int32_t)(32 + (((used - rsize) << 4) | need[r]));
            sub_base[r] = (int32_t)used;
            used += size;
        }
    }
    for (long s = 0; s < nsyms; s++) {
        int l = lengths[s];
        if (l <= 0) continue;
        uint32_t c = next_code[l]++;
        int32_t ent = zng_tbl2_ent(s, l, is_dist);
        if (l <= root) {
            long stride = 1L << l;
            for (long idx = (long)zng_bitrev(c, l); idx < rsize; idx += stride)
                tbl[idx] = ent;
        } else {
            uint32_t full = zng_bitrev(c, l);
            long ridx = (long)(full & (uint32_t)(rsize - 1));
            long base = sub_base[ridx];
            long ssize = 1L << need[ridx];
            long stride = 1L << (l - root);
            for (long idx = (long)(full >> root); idx < ssize; idx += stride)
                tbl[base + idx] = ent;
        }
    }
    return used;
}

/* Fixed-block tables (RFC 1951 3.2.6), built once per process. */
static int32_t FIX_LIT_TBL[1 << 10];
static int32_t FIX_DIST_TBL[1 << 6];
static int fix_lit_root = 0, fix_dist_root = 0;

static void zng_fix_init(void) {
    if (fix_lit_root) return;
    int32_t ll[288], dl[32];
    for (int i = 0; i < 144; i++) ll[i] = 8;
    for (int i = 144; i < 256; i++) ll[i] = 9;
    for (int i = 256; i < 280; i++) ll[i] = 7;
    for (int i = 280; i < 288; i++) ll[i] = 8;
    for (int i = 0; i < 32; i++) dl[i] = 5;
    int dr;
    zng_build_tbl2(ll, 288, 10, FIX_LIT_TBL, 1 << 10, &fix_lit_root, 0);
    zng_build_tbl2(dl, 32, 10, FIX_DIST_TBL, 1 << 6, &dr, 1);
    fix_dist_root = dr;
}

static inline int32_t tbl2_look(const int32_t *tbl, int root, uint64_t hold) {
    int32_t ent = tbl[hold & ((1u << root) - 1u)];
    if (ent < -16) {
        long s = -(long)ent - 32;
        ent = tbl[(1L << root) + (s >> 4)
                  + (long)((hold >> root) & ((1u << (s & 15)) - 1u))];
    }
    return ent;
}

/* One Huffman block body over two-level tables; same contract and return
 * codes as zng_decode_huff. */
static long zng_decode_huff2(const uint8_t *data, long nbytes,
                             long *bitpos_io, const int32_t *lt, int lroot,
                             const int32_t *dt, int droot, uint8_t *out,
                             long out_cap, long *out_len_io, long wsize,
                             int finish, long *ncodes_io) {
    long bp = *bitpos_io;
    long olen = *out_len_io;
    long ncodes = 0;
    const long total_bits = nbytes * 8;
    long ret;

    /* Fast loop (inffast_tpl.h:53-298 analog): persistent 56-bit hold
     * with a branchless top-up per symbol (the 64-bit REFILL trick,
     * inffast_tpl.h:142-147); copies may overshoot by up to 31 bytes (the
     * 290-byte slack guard covers 258 + 32). Errors and buffer edges fall
     * to the careful loop below; EOB completes here directly. */
    {
        const uint8_t *in = data + (bp >> 3);
        const uint8_t *inend = data + nbytes - 8;  /* last safe 8B load */
        if (in <= inend) {
            uint64_t hold;
            memcpy(&hold, in, 8);
            hold >>= (bp & 7);
            long bits = 56 - (bp & 7);
            hold &= (1ULL << bits) - 1;
            in += 7;
            for (;;) {
                if (in > inend || olen + 290 > out_cap) break;
                uint64_t chunk;                     /* top-up to >= 56 */
                memcpy(&chunk, in, 8);
                hold |= chunk << bits;
                in += (63 - bits) >> 3;
                bits |= 56;

                int32_t ent = tbl2_look(lt, lroot, hold);
                long nb, kind;
              have_ent:
                if (ent < 0) break;
                nb = ent & 15;
                kind = ent & 0x30;
                if (kind == 0) {
                    /* literal batch: emit while 15 valid bits remain */
                    hold >>= nb;
                    bits -= nb;
                    out[olen++] = (uint8_t)(ent >> 6);
                    ncodes++;
                    while (bits >= 15) {
                        ent = tbl2_look(lt, lroot, hold);
                        if (ent < 0 || (ent & 0x30) != 0) {
                            /* hand the looked-up non-literal entry straight
                             * to the match path when enough bits remain for
                             * its worst case (len 15+5, dist 15+13 = 48) —
                             * avoids a refill plus duplicate table lookup
                             * per match (inffast_tpl.h decodes dist in the
                             * same hold for the same reason) */
                            if (bits >= 48 && olen + 290 <= out_cap)
                                goto have_ent;
                            break;
                        }
                        out[olen++] = (uint8_t)(ent >> 6);
                        ncodes++;
                        hold >>= (ent & 15);
                        bits -= ent & 15;
                    }
                    continue;
                }
                if (kind == 0x20) {    /* length: base+extra in the entry */
                    uint64_t hold0 = hold;
                    long bits0 = bits;
                    hold >>= nb;
                    bits -= nb;
                    long e = (ent >> 14) & 15;
                    long length = 3 + ((ent >> 6) & 255)
                                  + (long)(hold & ((1u << e) - 1));
                    hold >>= e;
                    bits -= e;
                    int32_t dent = tbl2_look(dt, droot, hold);
                    long de = (dent >> 19) & 15;
                    if (dent < 0 || de == 15) {
                        hold = hold0;
                        bits = bits0;
                        break;
                    }
                    long dnb = dent & 15;
                    hold >>= dnb;
                    bits -= dnb;
                    long dist = 1 + ((dent >> 4) & 0x7FFF)
                                + (long)(hold & ((1u << de) - 1));
                    hold >>= de;
                    bits -= de;
                    if (dist > olen || dist > wsize) {
                        hold = hold0;
                        bits = bits0;
                        break;
                    }
                    ncodes++;
                    uint8_t *dst = out + olen;
                    const uint8_t *src = dst - dist;
                    olen += length;
                    if (dist >= 32) {
                        /* 32-byte stepped copy (chunkset_tpl.h CHUNKCOPY
                         * at AVX2 width); overlap-tolerant, dist >= chunk */
                        do {
                            memcpy(dst, src, 32);
                            dst += 32;
                            src += 32;
                            length -= 32;
                        } while (length > 0);
                    } else if (dist >= length) {
                        memcpy(dst, src, (size_t)length);
                    } else if (dist >= 8) {
                        do {
                            memcpy(dst, src, 8);
                            dst += 8;
                            src += 8;
                            length -= 8;
                        } while (length > 0);
                    } else if (dist == 1) {
                        /* run: 8-byte broadcast stores (chunkmemset_1) */
                        uint64_t pat = 0x0101010101010101ULL * src[0];
                        do {
                            memcpy(dst, &pat, 8);
                            dst += 8;
                            length -= 8;
                        } while (length > 0);
                    } else if (dist == 2 || dist == 4) {
                        /* 2/4-periodic: widen to a u64 pattern, store 8B
                         * chunks (chunkmemset_2/4 broadcast analog) */
                        uint64_t pat;
                        if (dist == 2) {
                            uint16_t p2;
                            memcpy(&p2, src, 2);
                            pat = 0x0001000100010001ULL * p2;
                        } else {
                            uint32_t p4;
                            memcpy(&p4, src, 4);
                            pat = p4 | ((uint64_t)p4 << 32);
                        }
                        do {
                            memcpy(dst, &pat, 8);
                            dst += 8;
                            length -= 8;
                        } while (length > 0);
                    } else {
                        /* odd short period (3,5,6,7): seed two periods,
                         * then grow with power-of-two memcpys */
                        for (long k = 0; k < 2 * dist; k++) dst[k] = src[k];
                        long copied = 2 * dist;
                        while (copied < length) {
                            long c = copied < length - copied
                                         ? copied : length - copied;
                            memcpy(dst + copied, dst, (size_t)c);
                            copied += c;
                        }
                    }
                    continue;
                }
                if (kind == 0x10) {    /* EOB inside the fast loop */
                    bits -= nb;
                    *bitpos_io = (in - data) * 8 - bits;
                    *out_len_io = olen;
                    *ncodes_io += ncodes + 1;
                    return 0;
                }
                break;  /* invalid: careful loop re-decodes exactly */
            }
            bp = (in - data) * 8 - bits;
        }
    }

    /* Careful tail loop: exact need-input rollbacks at symbol granularity */
    for (;;) {
        uint64_t hold;
        long byte = bp >> 3;
        long av = nbytes - byte;
        if (av >= 8) {
            memcpy(&hold, data + byte, 8);
        } else {
            hold = 0;
            for (long k = 0; k < av; k++)
                hold |= (uint64_t)data[byte + k] << (8 * k);
        }
        hold >>= (bp & 7);

        int32_t ent = tbl2_look(lt, lroot, hold);
        if (ent < 0) {
            if (bp + 15 > total_bits && !finish) { ret = 1; break; }
            ret = -2;
            break;
        }
        long nb = ent & 15;
        long kind = ent & 0x30;
        bp += nb;
        if (bp > total_bits) {
            if (finish) { ret = -5; break; }
            bp -= nb;
            ret = 1;
            break;
        }
        ncodes++;
        if (kind == 0) {
            if (olen >= out_cap) { bp -= nb; ncodes--; ret = 2; break; }
            out[olen++] = (uint8_t)(ent >> 6);
            continue;
        }
        if (kind == 0x10) { ret = 0; break; }
        if (kind == 0x30) { ret = -2; break; }
        hold >>= nb;
        long used = nb;
        long e = (ent >> 14) & 15;
        long length = 3 + ((ent >> 6) & 255) + (long)(hold & ((1u << e) - 1));
        hold >>= e;
        used += e;
        bp += e;

        int32_t dent = tbl2_look(dt, droot, hold);
        long de = (dent >> 19) & 15;
        if (dent < 0 || de == 15) {
            if (bp + 15 > total_bits && !finish) {
                bp -= used;
                ncodes--;
                ret = 1;
                break;
            }
            ret = -3;
            break;
        }
        long dnb = dent & 15;
        hold >>= dnb;
        used += dnb;
        bp += dnb;
        long dist = 1 + ((dent >> 4) & 0x7FFF)
                    + (long)(hold & ((1u << de) - 1));
        used += de;
        bp += de;
        if (bp > total_bits) {
            if (finish) { ret = -5; break; }
            bp -= used;
            ncodes--;
            ret = 1;
            break;
        }
        if (dist > olen || dist > wsize) { ret = -4; break; }
        if (olen + length > out_cap) { bp -= used; ncodes--; ret = 2; break; }
        {
            uint8_t *dst = out + olen;
            const uint8_t *src = dst - dist;
            if (dist >= 8 && dist >= length) {
                memcpy(dst, src, (size_t)length);
            } else {
                for (long k = 0; k < length; k++) dst[k] = src[k];
            }
            olen += length;
        }
    }
    *bitpos_io = bp;
    *out_len_io = olen;
    *ncodes_io += ncodes;
    return ret;
}

/* Whole-stream engine (the inflate.c:726-1153 block loop, host-native).
 *
 * st: int64[8] resumable state owned by the caller:
 *   [0] state (0 block header, 1 stored, 2 huffman body, 3 done)
 *   [1] final-block flag   [2] stored bytes remaining
 *   [3] lit root bits      [4] dist root bits      [5] fixed-tables flag
 * lit_tbl/dist_tbl: caller-owned two-level table buffers (persist across
 * calls so mid-block resumes reuse them).
 *
 * Returns: 0 stream end, 1 need input, 2 grow output, 3 block boundary
 * (only when stop_after_block), or a negative error:
 *   -1..-10 as zng_read_dyn_header / zng_decode_huff
 *   -11 invalid stored block lengths, -12 invalid block type,
 *   -13 internal table overflow (caller falls back; unreachable for
 *       Kraft-valid code sets with the documented caps).
 */
long zng_inflate_stream(const uint8_t *data, long nbytes, long *bitpos_io,
                        int64_t *st, int32_t *lit_tbl, long lit_cap,
                        int32_t *dist_tbl, long dist_cap, uint8_t *out,
                        long out_cap, long *out_len_io, long wsize,
                        int finish, long *ncodes_io, int stop_after_block) {
    zng_fix_init();
    long bp = *bitpos_io;
    long olen = *out_len_io;
    long ncodes = 0;
    const long total_bits = nbytes * 8;
    long state = (long)st[0];
    long ret = 0;

    for (;;) {
        if (state == 3) { ret = 0; break; }
        if (state == 0) {
            if (total_bits - bp < 3) { ret = finish ? -5 : 1; break; }
            long save = bp;
            long final = (long)zng_peek(data, nbytes, bp, 1); bp += 1;
            long btype = (long)zng_peek(data, nbytes, bp, 2); bp += 2;
            if (btype == 3) { ret = -12; break; }
            if (btype == 0) {
                bp = (bp + 7) & ~7L;
                if (total_bits - bp < 32) {
                    bp = save;
                    ret = finish ? -5 : 1;
                    break;
                }
                long len = (long)zng_peek(data, nbytes, bp, 16); bp += 16;
                long nlen = (long)zng_peek(data, nbytes, bp, 16); bp += 16;
                if (len != (~nlen & 0xFFFF)) { ret = -11; break; }
                st[1] = final;
                st[2] = len;
                state = 1;
                continue;
            }
            if (btype == 1) {
                st[1] = final;
                st[5] = 1;
                st[3] = fix_lit_root;
                st[4] = fix_dist_root;
                state = 2;
                continue;
            }
            int32_t lengths[318];
            long hlit, hdist;
            long r = zng_parse_dyn_lengths(data, nbytes, &bp, lengths,
                                           &hlit, &hdist);
            if (r == 1) { bp = save; ret = finish ? -5 : 1; break; }
            if (r < 0) { ret = r; break; }
            int lr, dr;
            /* root 10 (inflate.c:904): vs 11 the halved per-block build
             * cost wins ~2.5% on text (measured, bench/microdec.c) */
            if (zng_build_tbl2(lengths, hlit, 10, lit_tbl, lit_cap,
                               &lr, 0) < 0
                || zng_build_tbl2(lengths + hlit, hdist, 10, dist_tbl,
                                  dist_cap, &dr, 1) < 0) {
                bp = save; /* caller retries this block on the flat path */
                ret = -13;
                break;
            }
            st[1] = final;
            st[5] = 0;
            st[3] = lr;
            st[4] = dr;
            state = 2;
            continue;
        }
        if (state == 1) {
            long remaining = (long)st[2];
            long avail = nbytes - (bp >> 3);
            long take = remaining < avail ? remaining : avail;
            if (take > out_cap - olen) take = out_cap - olen;
            if (take > 0) {
                memcpy(out + olen, data + (bp >> 3), (size_t)take);
                olen += take;
                bp += take * 8;
                remaining -= take;
                st[2] = remaining;
            }
            if (remaining > 0) {
                if (nbytes - (bp >> 3) > 0 && out_cap == olen) {
                    ret = 2;
                    break;
                }
                ret = finish ? -5 : 1;
                break;
            }
            if (st[1]) { state = 3; continue; }
            state = 0;
            if (stop_after_block) { ret = 3; break; }
            continue;
        }
        /* state == 2 */
        {
            const int32_t *lt = st[5] ? FIX_LIT_TBL : lit_tbl;
            const int32_t *dt = st[5] ? FIX_DIST_TBL : dist_tbl;
            long r = zng_decode_huff2(data, nbytes, &bp, lt, (int)st[3], dt,
                                      (int)st[4], out, out_cap, &olen, wsize,
                                      finish, &ncodes);
            if (r != 0) { ret = r; break; }
            if (st[1]) { state = 3; continue; }
            state = 0;
            if (stop_after_block) { ret = 3; break; }
        }
    }
    st[0] = state;
    *bitpos_io = bp;
    *out_len_io = olen;
    *ncodes_io += ncodes;
    return ret;
}

/* ---- Encode-side Huffman table build (stage-2 host batching) ----
 *
 * TPU-framework analog of trees.c build_tree/gen_bitlen/gen_codes
 * (trees.c:185-405): sorted-merge (Moffat-Katajainen) length construction
 * plus EXACT Kraft restoration, with tie-breaking identical to
 * huffman/encode.py so native and numpy outputs are bit-identical. The
 * per-group Python tree build was the stage-2 host bottleneck (~1.1 ms per
 * merged block group); these run in ~10 us.
 */
typedef struct { int64_t freq; int32_t idx; int32_t len; } hsym_t;

static int hsym_cmp_freq(const void *pa, const void *pb) {
    const hsym_t *a = (const hsym_t *)pa, *b = (const hsym_t *)pb;
    if (a->freq != b->freq) return a->freq < b->freq ? -1 : 1;
    return a->idx < b->idx ? -1 : 1;      /* stable: index ascending */
}

static int hsym_cmp_lenfreq(const void *pa, const void *pb) {
    /* (length asc, freq desc, idx asc) — the _limit_lengths reassignment
     * order (key = len*(maxfreq+1) - freq over index-ascending symbols) */
    const hsym_t *a = (const hsym_t *)pa, *b = (const hsym_t *)pb;
    if (a->len != b->len) return a->len < b->len ? -1 : 1;
    if (a->freq != b->freq) return a->freq > b->freq ? -1 : 1;
    return a->idx < b->idx ? -1 : 1;
}

static uint32_t bitrev_len(uint32_t c, int len) {
    uint32_t r = 0;
    for (int k = 0; k < len; k++) r |= ((c >> k) & 1u) << (len - 1 - k);
    return r;
}

/* lengths[n], codes_rev[n] (LSB-first canonical codes) from freqs[n]. */
void zng_huff_table(const int64_t *freqs, long n, int max_bits,
                    int32_t *lengths, int32_t *codes_rev) {
    hsym_t syms[320];
    int64_t a[320];
    int32_t depths[320];
    long m = 0;
    for (long i = 0; i < n; i++) {
        lengths[i] = 0;
        codes_rev[i] = 0;
        if (freqs[i] > 0) {
            syms[m].freq = freqs[i];
            syms[m].idx = (int32_t)i;
            m++;
        }
    }
    if (m == 0) return;
    if (m == 1) {
        lengths[syms[0].idx] = 1;
        /* canonical: single 1-bit code 0 */
        return;
    }
    qsort(syms, (size_t)m, sizeof(hsym_t), hsym_cmp_freq);
    for (long i = 0; i < m; i++) a[i] = syms[i].freq;
    /* phase 1: in-place merge builds parent pointers / internal weights */
    {
        long s = 0, r = 0;
        for (long t = 0; t < m - 1; t++) {
            if (s >= m || (r < t && a[r] < a[s])) { a[t] = a[r]; a[r] = t; r++; }
            else { a[t] = a[s]; s++; }
            if (s >= m || (r < t && a[r] < a[s])) { a[t] += a[r]; a[r] = t; r++; }
            else { a[t] += a[s]; s++; }
        }
    }
    /* phase 2: internal depths right-to-left */
    a[m - 2] = 0;
    for (long t = m - 3; t >= 0; t--) a[t] = a[a[t]] + 1;
    /* phase 3: leaf depth counting */
    {
        long avail = 1, depth = 0, t = m - 2, out_i = 0;
        while (avail > 0) {
            long usedn = 0;
            while (t >= 0 && a[t] == depth) { usedn++; t--; }
            for (long k = 0; k < avail - usedn; k++) depths[out_i++] = (int32_t)depth;
            avail = 2 * usedn;
            depth++;
        }
    }
    /* depths are shallowest-first = most-frequent-first; syms sorted asc */
    int32_t maxlen = 0;
    for (long i = 0; i < m; i++) {
        int32_t d = depths[m - 1 - i];
        lengths[syms[i].idx] = d;
        syms[i].len = d;
        if (d > maxlen) maxlen = d;
    }
    if (maxlen > max_bits) {
        /* exact Kraft restore (huffman/encode._limit_lengths): clamp, then
         * demote one level-(bits) leaf + promote one max-depth leaf per
         * oversubscription unit */
        long bl_count[64] = {0};
        for (long i = 0; i < m; i++) {
            int32_t l = syms[i].len > max_bits ? max_bits : syms[i].len;
            syms[i].len = l;
            bl_count[l]++;
        }
        int64_t kraft = 0;
        for (int b = 1; b <= max_bits; b++)
            kraft += bl_count[b] << (max_bits - b);
        int64_t target = (int64_t)1 << max_bits;
        while (kraft > target) {
            int bits = max_bits - 1;
            while (bl_count[bits] == 0) bits--;
            bl_count[bits]--;
            bl_count[bits + 1] += 2;
            bl_count[max_bits]--;
            kraft--;
        }
        qsort(syms, (size_t)m, sizeof(hsym_t), hsym_cmp_lenfreq);
        long out_i = 0;
        for (int b = 0; b <= max_bits; b++)
            for (long k = 0; k < bl_count[b]; k++)
                lengths[syms[out_i++].idx] = b;
    }
    /* canonical codes (RFC 1951 3.2.2) + per-length bit reversal */
    {
        long blc[64] = {0};
        uint32_t next_code[64];
        for (long i = 0; i < n; i++) if (lengths[i] > 0) blc[lengths[i]]++;
        uint32_t code = 0;
        for (int b = 1; b <= max_bits; b++) {
            code = (uint32_t)((code + blc[b - 1]) << 1);
            next_code[b] = code;
        }
        for (long i = 0; i < n; i++) {
            int l = lengths[i];
            if (l > 0) codes_rev[i] = (int32_t)bitrev_len(next_code[l]++, l);
        }
    }
}

/* Dynamic-block header tokens (send_all_trees analog, trees.c:454-521):
 * emits (val,bits) pairs: HLIT HDIST HCLEN, the permuted cl lengths, and
 * the RLE'd lit+dist length stream under the cl tree. Returns the token
 * count; *total_bits gets the summed width. tok arrays need >= 720 slots. */
long zng_dyn_header(const int32_t *lit_len, long nlit,
                    const int32_t *dist_len, long ndist,
                    int32_t *tok_val, int32_t *tok_bits, long *total_bits) {
    long hlit = 257, hdist = 1;
    for (long i = 0; i < nlit; i++) if (lit_len[i] > 0 && i + 1 > hlit) hlit = i + 1;
    for (long i = 0; i < ndist; i++) if (dist_len[i] > 0 && i + 1 > hdist) hdist = i + 1;
    int32_t all[320];
    long nall = 0;
    for (long i = 0; i < hlit; i++) all[nall++] = lit_len[i];
    for (long i = 0; i < hdist; i++) all[nall++] = dist_len[i];
    /* RLE with 16/17/18 exactly like scan_tree (trees.c:411-453) */
    int32_t rle_sym[700], rle_extra[700];
    long nrle = 0;
    int32_t prev = -1;
    for (long i = 0; i < nall; ) {
        int32_t cur = all[i];
        long run = 1;
        while (i + run < nall && all[i + run] == cur) run++;
        if (cur == 0) {
            long r = run;
            while (r >= 11) {
                long take = r < 138 ? r : 138;
                rle_sym[nrle] = 18; rle_extra[nrle++] = (int32_t)(take - 11);
                r -= take;
            }
            if (r >= 3) { rle_sym[nrle] = 17; rle_extra[nrle++] = (int32_t)(r - 3); r = 0; }
            while (r-- > 0) { rle_sym[nrle] = 0; rle_extra[nrle++] = -1; }
        } else {
            long r = run;
            if (cur != prev) { rle_sym[nrle] = cur; rle_extra[nrle++] = -1; r--; }
            while (r >= 3) {
                long take = r < 6 ? r : 6;
                rle_sym[nrle] = 16; rle_extra[nrle++] = (int32_t)(take - 3);
                r -= take;
            }
            while (r-- > 0) { rle_sym[nrle] = cur; rle_extra[nrle++] = -1; }
        }
        prev = cur;
        i += run;
    }
    int64_t cl_freq[19] = {0};
    for (long i = 0; i < nrle; i++) cl_freq[rle_sym[i]]++;
    int32_t cl_len[19], cl_code[19];
    zng_huff_table(cl_freq, 19, 7, cl_len, cl_code);
    long hclen = 4;
    for (long i = 0; i < 19; i++)
        if (cl_len[BL_ORD[i]] > 0 && i + 1 > hclen) hclen = i + 1;
    long nt = 0;
    tok_val[nt] = (int32_t)(hlit - 257); tok_bits[nt++] = 5;
    tok_val[nt] = (int32_t)(hdist - 1);  tok_bits[nt++] = 5;
    tok_val[nt] = (int32_t)(hclen - 4);  tok_bits[nt++] = 4;
    for (long i = 0; i < hclen; i++) {
        tok_val[nt] = cl_len[BL_ORD[i]]; tok_bits[nt++] = 3;
    }
    for (long i = 0; i < nrle; i++) {
        int32_t s = rle_sym[i];
        tok_val[nt] = cl_code[s]; tok_bits[nt++] = cl_len[s];
        if (s >= 16) {
            tok_val[nt] = rle_extra[i];
            tok_bits[nt++] = s == 16 ? 2 : (s == 17 ? 3 : 7);
        }
    }
    int64_t tb = 0;
    for (long i = 0; i < nt; i++) tb += tok_bits[i];
    *total_bits = tb;
    return nt;
}

/* Entropy + extra-bits + header-model estimate of one dynamic block
 * (ops/deflate_tpu._est_block_bits): drives the stored pre-pass and the
 * block agglomeration merge decisions. lfreq[286], dfreq[30]. */
#include <math.h>
double zng_est_block_bits(const int64_t *lfreq, const int64_t *dfreq) {
    double bits = 0.0;
    long used = 0;
    int64_t ltot = 0, dtot = 0;
    for (int i = 0; i < 286; i++) ltot += lfreq[i];
    for (int i = 0; i < 30; i++) dtot += dfreq[i];
    for (int i = 257; i < 286; i++) bits += (double)lfreq[i] * LE[i - 257];
    for (int i = 0; i < 30; i++) bits += (double)dfreq[i] * DE[i];
    if (ltot) {
        double lt = log2((double)ltot);
        for (int i = 0; i < 286; i++)
            if (lfreq[i] > 0) {
                bits += (double)lfreq[i] * (lt - log2((double)lfreq[i]));
                used++;
            }
    }
    if (dtot) {
        double dt2 = log2((double)dtot);
        for (int i = 0; i < 30; i++)
            if (dfreq[i] > 0) {
                bits += (double)dfreq[i] * (dt2 - log2((double)dfreq[i]));
                used++;
            }
    }
    return bits + 3 + 14 + 57 + 5 * (double)used;
}
