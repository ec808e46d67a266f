// Shared byte-wise range decoder + Laplace (RFC 6716 sec. 4.1).
// Extracted from celt_frontend.cpp; used by both the CELT and SILK
// native plane-A engines.  Mirrors opus_tpu/rc (bit-exact).
#pragma once
#include <cstdint>
#include <algorithm>

namespace opusfe {


// ---------------------------------------------------------------------------
// Range decoder (RFC 6716 sec. 4.1) — mirrors opus_tpu/rc/decoder.py.
// ---------------------------------------------------------------------------

constexpr int BITRES = 3;
constexpr int UINT_BITS = 8;
constexpr int WINDOW_SIZE = 32;
constexpr int SYM_BITS = 8;
constexpr int CODE_BITS = 32;
constexpr uint32_t SYM_MAX = (1u << SYM_BITS) - 1;
constexpr uint32_t CODE_TOP = 1u << (CODE_BITS - 1);
constexpr uint32_t CODE_BOT = CODE_TOP >> SYM_BITS;
constexpr int CODE_EXTRA = (CODE_BITS - 2) % SYM_BITS + 1;

static inline int ilog32(uint32_t v) { return v ? 32 - __builtin_clz(v) : 0; }

constexpr uint16_t TELL_FRAC_CORR[8] = {35733, 38967, 42495, 46340, 50535, 55109, 60097, 65535};

struct RangeDec {
    const uint8_t* buf;
    int storage;
    int offs;
    int end_offs;
    uint32_t end_window;
    int nend_bits;
    int bits_total;
    uint32_t rng;
    uint32_t val;
    uint32_t ext;
    bool error;
    uint32_t rem;

    int read_byte() { return offs < storage ? buf[offs++] : 0; }
    int read_byte_from_end() {
        if (end_offs < storage) { end_offs++; return buf[storage - end_offs]; }
        return 0;
    }
    void normalize() {
        while (rng <= CODE_BOT) {
            bits_total += SYM_BITS;
            rng <<= SYM_BITS;
            uint32_t sym = rem;
            rem = (uint32_t)read_byte();
            sym = ((sym << SYM_BITS) | rem) >> (SYM_BITS - CODE_EXTRA);
            val = ((val << SYM_BITS) + (SYM_MAX & ~sym)) & (CODE_TOP - 1);
        }
    }
    void init(const uint8_t* b, int len) {
        buf = b; storage = len; offs = 0;
        end_offs = 0; end_window = 0; nend_bits = 0;
        bits_total = CODE_BITS + 1 - ((CODE_BITS - CODE_EXTRA) / SYM_BITS) * SYM_BITS;
        ext = 0; error = false;
        rng = 1u << CODE_EXTRA;
        rem = (uint32_t)read_byte();
        val = rng - 1 - (rem >> (SYM_BITS - CODE_EXTRA));
        normalize();
    }
    int tell() const { return bits_total - ilog32(rng); }
    uint32_t tell_frac() const {
        uint32_t bits = (uint32_t)bits_total << BITRES;
        int l = ilog32(rng);
        uint32_t r = rng >> (l - 16);
        int b = (int)(r >> 12) - 8;
        if (r > TELL_FRAC_CORR[b]) b++;
        return bits - (uint32_t)((l << 3) + b);
    }
    uint32_t decode(uint32_t ft) {
        ext = rng / ft;
        uint32_t s = val / ext;
        return ft - std::min(s + 1, ft);
    }
    uint32_t decode_bin(int bits) {
        ext = rng >> bits;
        uint32_t s = val / ext;
        return (1u << bits) - std::min(s + 1, (uint32_t)1 << bits);
    }
    void update(uint32_t fl, uint32_t fh, uint32_t ft) {
        uint32_t s = ext * (ft - fh);
        val -= s;
        rng = fl > 0 ? ext * (fh - fl) : rng - s;
        normalize();
    }
    bool decode_bit_logp(int logp) {
        uint32_t r = rng, d = val;
        uint32_t s = r >> logp;
        bool ret = d < s;
        if (!ret) val = d - s;
        rng = ret ? s : r - s;
        normalize();
        return ret;
    }
    int decode_icdf(const uint8_t* icdf, int ftb) {
        uint32_t s = rng, d = val, t;
        uint32_t r = s >> ftb;
        int ret = -1;
        do {
            ret++;
            t = s;
            s = r * icdf[ret];
        } while (d < s);
        val = d - s;
        rng = t - s;
        normalize();
        return ret;
    }
    uint32_t decode_bits(int bits) {
        uint32_t window = end_window;
        int available = nend_bits;
        if (available < bits) {
            do {
                window |= (uint32_t)read_byte_from_end() << available;
                available += SYM_BITS;
            } while (available <= WINDOW_SIZE - SYM_BITS);
        }
        uint32_t ret = window & ((bits < 32 ? (1u << bits) : 0u) - 1u);
        window >>= bits;
        available -= bits;
        end_window = window;
        nend_bits = available;
        bits_total += bits;
        return ret;
    }
    uint32_t decode_uint(uint32_t ft) {
        // ft > 1 guaranteed by callers.
        ft--;
        int ftb = ilog32(ft);
        if (ftb > UINT_BITS) {
            ftb -= UINT_BITS;
            uint32_t ft1 = (ft >> ftb) + 1;
            uint32_t s = decode(ft1);
            update(s, s + 1, ft1);
            uint32_t t = (s << ftb) | decode_bits(ftb);
            if (t <= ft) return t;
            error = true;
            return ft;
        }
        uint32_t s = decode(ft + 1);
        update(s, s + 1, ft + 1);
        return s;
    }
};

// ---------------------------------------------------------------------------
// Laplace decode (opus_tpu/rc/laplace.py).
// ---------------------------------------------------------------------------

constexpr int LAPLACE_MINP = 1;
constexpr int LAPLACE_NMIN = 16;

static int laplace_freq1(int fs0, int decay) {
    int ft = 32768 - LAPLACE_MINP * (2 * LAPLACE_NMIN) - fs0;
    return (ft * (16384 - decay)) >> 15;
}

static int decode_laplace(RangeDec& dec, int fs, int decay) {
    int val = 0;
    uint32_t fl = 0;
    uint32_t fm = dec.decode_bin(15);
    if (fm >= (uint32_t)fs) {
        val += 1;
        fl = fs;
        fs = laplace_freq1(fs, decay) + LAPLACE_MINP;
        while (fs > LAPLACE_MINP && fm >= fl + 2 * (uint32_t)fs) {
            fs *= 2;
            fl += fs;
            fs = ((fs - 2 * LAPLACE_MINP) * decay) >> 15;
            fs += LAPLACE_MINP;
            val += 1;
        }
        if (fs <= LAPLACE_MINP) {
            int di = (int)((fm - fl) >> 1);
            val += di;
            fl += 2u * (uint32_t)di * LAPLACE_MINP;
        }
        if (fm < fl + (uint32_t)fs) {
            val = -val;
        } else {
            fl += fs;
        }
    }
    uint32_t fh = std::min<uint32_t>(fl + fs, 32768);
    dec.update(fl, fh, 32768);
    return val;
}


// ---------------------------------------------------------------------------
// Range encoder (RFC 6716 sec. 4.1) — mirrors opus_tpu/rc/encoder.py.
// ---------------------------------------------------------------------------

constexpr int CODE_SHIFT = CODE_BITS - SYM_BITS - 1;

struct RangeEnc {
    uint8_t* buf;
    int storage;
    int offs;
    int end_offs;
    uint32_t end_window;
    int nend_bits;
    int bits_total;
    uint32_t rng;
    uint32_t val;
    uint32_t ext;
    int rem;  // -1 = none buffered
    bool error;

    void init(uint8_t* b, int len) {
        buf = b; storage = len; offs = 0;
        end_offs = 0; end_window = 0; nend_bits = 0;
        bits_total = CODE_BITS + 1;
        rng = CODE_TOP; val = 0; ext = 0; rem = -1; error = false;
    }
    void write_byte(uint32_t v) {
        if (offs + end_offs >= storage) { error = true; return; }
        buf[offs++] = (uint8_t)(v & 0xFF);
    }
    void write_byte_at_end(uint32_t v) {
        if (offs + end_offs >= storage) { error = true; return; }
        end_offs++;
        buf[storage - end_offs] = (uint8_t)(v & 0xFF);
    }
    void carry_out(uint32_t c) {
        if (c != SYM_MAX) {
            uint32_t carry = c >> SYM_BITS;
            if (rem >= 0) write_byte((uint32_t)rem + carry);
            if (ext > 0) {
                uint32_t sym = (SYM_MAX + carry) & SYM_MAX;
                while (ext > 0) { write_byte(sym); ext--; }
            }
            rem = (int)(c & SYM_MAX);
        } else {
            ext++;
        }
    }
    void normalize() {
        while (rng <= CODE_BOT) {
            carry_out(val >> CODE_SHIFT);
            val = (val << SYM_BITS) & (CODE_TOP - 1);
            rng <<= SYM_BITS;
            bits_total += SYM_BITS;
        }
    }
    int tell() const { return bits_total - ilog32(rng); }
    uint32_t tell_frac() const {
        uint32_t bits = (uint32_t)bits_total << BITRES;
        int l = ilog32(rng);
        uint32_t r = rng >> (l - 16);
        int b = (int)(r >> 12) - 8;
        if (r > TELL_FRAC_CORR[b]) b++;
        return bits - (uint32_t)((l << 3) + b);
    }
    void encode(uint32_t fl, uint32_t fh, uint32_t ft) {
        uint32_t r = rng / ft;
        if (fl > 0) {
            val += rng - r * (ft - fl);
            rng = r * (fh - fl);
        } else {
            rng -= r * (ft - fh);
        }
        normalize();
    }
    void encode_bin(uint32_t fl, uint32_t fh, int bits) {
        uint32_t r = rng >> bits;
        if (fl > 0) {
            val += rng - r * ((1u << bits) - fl);
            rng = r * (fh - fl);
        } else {
            rng -= r * ((1u << bits) - fh);
        }
        normalize();
    }
    void encode_bit_logp(int bit, int logp) {
        uint32_t r = rng;
        uint32_t s = r >> logp;
        r -= s;
        if (bit) val += r;
        rng = bit ? s : r;
        normalize();
    }
    void encode_icdf(int symbol, const uint8_t* icdf, int ftb) {
        uint32_t r = rng >> ftb;
        if (symbol > 0) {
            val += rng - r * icdf[symbol - 1];
            rng = r * (uint32_t)(icdf[symbol - 1] - icdf[symbol]);
        } else {
            rng -= r * icdf[symbol];
        }
        normalize();
    }
    void encode_bits(uint32_t fl, int bits) {
        uint32_t window = end_window;
        int used = nend_bits;
        if (used + bits > WINDOW_SIZE) {
            while (used >= SYM_BITS) {
                write_byte_at_end(window & SYM_MAX);
                window >>= SYM_BITS;
                used -= SYM_BITS;
            }
        }
        window |= fl << used;
        used += bits;
        end_window = window;
        nend_bits = used;
        bits_total += bits;
    }
    void encode_uint(uint32_t fl, uint32_t ft) {
        ft--;
        int ftb = ilog32(ft);
        if (ftb > UINT_BITS) {
            ftb -= UINT_BITS;
            uint32_t ft1 = (ft >> ftb) + 1;
            uint32_t fl1 = fl >> ftb;
            encode(fl1, fl1 + 1, ft1);
            encode_bits(fl & ((1u << ftb) - 1), ftb);
        } else {
            encode(fl, fl + 1, ft + 1);
        }
    }
    void shrink(int new_size) {
        // Compact the raw-bit tail so the stream fits new_size bytes
        // (rc/encoder.py shrink; caller guarantees offs+end_offs fit).
        if (end_offs > 0)
            std::memmove(buf + new_size - end_offs, buf + storage - end_offs,
                         (size_t)end_offs);
        storage = new_size;
    }
    void done() {
        int l = CODE_BITS - ilog32(rng);
        uint32_t msk = (CODE_TOP - 1) >> l;
        uint32_t end = (val + msk) & ~msk;
        if ((end | msk) >= val + rng) {
            l++;
            msk >>= 1;
            end = (val + msk) & ~msk;
        }
        while (l > 0) {
            carry_out(end >> CODE_SHIFT);
            end = (end << SYM_BITS) & (CODE_TOP - 1);
            l -= SYM_BITS;
        }
        if (rem >= 0 || ext > 0) carry_out(0);
        uint32_t window = end_window;
        int used = nend_bits;
        while (used >= SYM_BITS) {
            write_byte_at_end(window & SYM_MAX);
            window >>= SYM_BITS;
            used -= SYM_BITS;
        }
        if (!error) {
            for (int i = offs; i < storage - end_offs; i++) buf[i] = 0;
            if (used > 0) {
                if (end_offs >= storage) {
                    error = true;
                } else {
                    l = -l;
                    if (offs + end_offs >= storage && l < used) {
                        window &= (1u << l) - 1;
                        error = true;
                    }
                    buf[storage - end_offs - 1] |= (uint8_t)(window & 0xFF);
                }
            }
        }
    }
};

// Laplace encode (opus_tpu/rc/laplace.py encode_laplace).  Returns the
// (possibly magnitude-clamped) value actually coded.
static int encode_laplace(RangeEnc& enc, int value, int fs, int decay) {
    int fl = 0;
    int val = value;
    if (val != 0) {
        int s = val < 0 ? -1 : 0;
        val = (val + s) ^ s;
        fl = fs;
        fs = laplace_freq1(fs, decay);
        int i = 1;
        while (fs > 0 && i < val) {
            fs *= 2;
            fl += fs + 2 * LAPLACE_MINP;
            fs = (fs * decay) >> 15;
            i++;
        }
        if (fs == 0) {
            int ndi_max = (32768 - fl + LAPLACE_MINP - 1) >> 0;  // LOG_MINP=0
            ndi_max = (ndi_max - s) >> 1;
            int di = std::min(val - i, ndi_max - 1);
            fl += (2 * di + 1 + s) * LAPLACE_MINP;
            fs = std::min(LAPLACE_MINP, 32768 - fl);
            value = (i + di + s) ^ s;
        } else {
            fs += LAPLACE_MINP;
            if (s == 0) fl += fs;
        }
    }
    enc.encode_bin(fl, fl + fs, 15);
    return value;
}

}  // namespace opusfe
