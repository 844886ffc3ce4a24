/* hostops.c — native host-side runtime kernels (ctypes).
 *
 * Host-side hot loops of the port (a copy of the JAX package's
 * native/hostops.c, without its read encoder, which the port never
 * calls): Elias-gamma offset expansion and packing for the compressed
 * k-mer index (the equivalent of the reference's gamma decode,
 * genome_hr.h:22-29, needed when opening databases built with basesize
 * < kmer, and of its writer, indexdb.c:1979-2039, when building them)
 * and SAM line assembly for gapless substitution hits.
 *
 * Build: cc -O3 -shared -fPIC -o libhostops.so hostops.c
 */

#include <stdint.h>
#include <stddef.h>

/* Expand blocked Elias-gamma offsets (see indexdb.py write_offsets_gamma
 * for the bit layout) into a flat uint32 array of length n_oligos + 1.
 * Returns 0 on success. */
int
gamma_expand_offsets(const uint32_t *gammaptrs, const uint32_t *comp,
                     uint32_t *out, uint64_t n_oligos, uint32_t blocksize)
{
    uint64_t oligok = 0;
    uint64_t nblocks = n_oligos / blocksize;
    for (uint64_t b = 0; b < nblocks; b++) {
        uint64_t ptr = gammaptrs[b];
        uint32_t cum = comp[ptr++];
        out[oligok++] = cum;
        uint32_t word = comp[ptr];
        int bit = 0;  /* bits consumed from MSB of current word */
        for (uint32_t j = 1; j < blocksize; j++) {
            int zeros = 0;
            while (((word >> (31 - bit)) & 1u) == 0u) {
                zeros++;
                if (++bit == 32) { word = comp[++ptr]; bit = 0; }
            }
            uint32_t value = 0;
            for (int t = 0; t <= zeros; t++) {
                value = (value << 1) | ((word >> (31 - bit)) & 1u);
                if (++bit == 32) { ptr++; word = comp[ptr]; bit = 0; }
            }
            cum += value - 1u;
            out[oligok++] = cum;
        }
    }
    out[oligok] = comp[gammaptrs[nblocks]];
    return 0;
}

/* Pack blocked Elias-gamma offsets (Indexdb_write_offsets,
 * indexdb.c:1979-2039 bit layout; the JAX package's gamma_write_offsets,
 * and the same bytes as db/indexdb.py's Python writer).  gammaptrs:
 * nblocks+1 entries; words: caller-allocated worst case (per block 1 +
 * ceil((blocksize-1)*65/32) + 1 slack, + 1 final total).  Returns the
 * word count written. */
int64_t
gamma_pack_offsets(const uint32_t *offsets, uint64_t n_oligos,
                   uint32_t blocksize, uint32_t *gammaptrs, uint32_t *words)
{
    uint64_t nblocks = n_oligos / blocksize;
    int64_t w = 0;
    for (uint64_t b = 0; b < nblocks; b++) {
        uint64_t blk = b * blocksize;
        gammaptrs[b] = (uint32_t) w;
        words[w++] = offsets[blk];
        uint64_t buffer = 0;
        int ctr = 32;
        for (uint32_t j = 1; j < blocksize; j++) {
            uint64_t gamma =
                (uint64_t) (offsets[blk + j] - offsets[blk + j - 1]) + 1u;
            int nbits = 0;
            for (uint64_t g = gamma; g > 1; g >>= 1) nbits++;
            int length = 2 * nbits + 1;
            while (length > ctr) {
                if (length - ctr < 32)
                    buffer |= gamma >> (length - ctr);
                words[w++] = (uint32_t) (buffer & 0xFFFFFFFFu);
                length -= ctr;
                ctr = 32;
                buffer = 0;
            }
            buffer |= (gamma << (ctr - length)) & 0xFFFFFFFFu;
            ctr -= length;
        }
        words[w++] = (uint32_t) (buffer & 0xFFFFFFFFu);
    }
    gammaptrs[nblocks] = (uint32_t) w;
    words[w++] = offsets[n_oligos];
    return w;
}

/* ---------------------------------------------------------------------
 * SAM line assembly for gapless substitution hits (the dominant SE/PE
 * success shape: CIGAR = [t5 S] m M [t3 S]).  Replaces the per-read
 * Python of runner._pe_sam_fast/_se_sam_fast tails (sam.pe_record +
 * _md_from_positions), which dominated end-to-end emission profiles.
 * Tag layout mirrors io/sam.py pe_record/se_record exactly:
 *   MD NH HI NM SM XQ X2  (SM = mapq).
 */

static inline char *
put_long(char *p, long v)
{
    char tmp[24];
    int t = 0;
    if (v < 0) { *p++ = '-'; v = -v; }
    do { tmp[t++] = (char)('0' + v % 10); v /= 10; } while (v);
    while (t) *p++ = tmp[--t];
    return p;
}

static inline char *
put_str(char *p, const char *s, long n)
{
    for (long i = 0; i < n; i++) p[i] = s[i];
    return p + n;
}

/* One SAM line per row; rnext code: -2 -> "*", -1 -> "=", else chr idx.
 * seq/qual are row-major [n, lmax] in PRINT orientation; hasq[i]==0
 * prints "*".  MD runs come as span-relative ascending mismatch
 * positions (mdpos) + genome chars (mdch), one slice per row via mdoff.
 * Returns bytes written, or -1 when cap would overflow. */
long
sam_sub_lines(long n,
              const char *labblob, const uint32_t *lab_start,
              const uint32_t *lab_len,
              const uint8_t *seq, const char *qual, long lmax,
              const int32_t *L, const uint8_t *hasq,
              const char *chrblob, const uint32_t *chr_off,
              const int32_t *chridx,
              const int64_t *pos, const int32_t *flag, const int32_t *mapq,
              const int32_t *rnext, const int64_t *pnext,
              const int64_t *tlen,
              const int32_t *t5, const int32_t *t3,
              const int32_t *nm, const int32_t *nh, const int32_t *hi,
              const int32_t *xq, const int32_t *x2,
              const int32_t *mdpos, const uint32_t *mdoff,
              const char *mdch,
              char *buf, long cap, int64_t *out_off)
{
    char *p = buf;
    char *end = buf + cap;
    for (long i = 0; i < n; i++) {
        out_off[i] = p - buf;
        long li = L[i];
        /* worst case: label + 11 tabs + numbers + seq + qual + tags */
        if (end - p < (long)lab_len[i] + 2 * li + 256) return -1;
        p = put_str(p, labblob + lab_start[i], lab_len[i]);
        *p++ = '\t';
        p = put_long(p, flag[i]); *p++ = '\t';
        { const char *c = chrblob + chr_off[chridx[i]];
          long cl = chr_off[chridx[i] + 1] - chr_off[chridx[i]];
          p = put_str(p, c, cl); }
        *p++ = '\t';
        p = put_long(p, pos[i]); *p++ = '\t';
        p = put_long(p, mapq[i]); *p++ = '\t';
        /* CIGAR: [t5 S] m M [t3 S] */
        if (t5[i]) { p = put_long(p, t5[i]); *p++ = 'S'; }
        p = put_long(p, li - t5[i] - t3[i]); *p++ = 'M';
        if (t3[i]) { p = put_long(p, t3[i]); *p++ = 'S'; }
        *p++ = '\t';
        if (rnext[i] == -2) *p++ = '*';
        else if (rnext[i] == -1) *p++ = '=';
        else { const char *c = chrblob + chr_off[rnext[i]];
               long cl = chr_off[rnext[i] + 1] - chr_off[rnext[i]];
               p = put_str(p, c, cl); }
        *p++ = '\t';
        p = put_long(p, pnext[i]); *p++ = '\t';
        p = put_long(p, tlen[i]); *p++ = '\t';
        p = put_str(p, (const char *) seq + i * lmax, li); *p++ = '\t';
        if (hasq[i]) p = put_str(p, qual + i * lmax, li);
        else *p++ = '*';
        *p++ = '\t';
        /* MD:Z: exact _md_from_positions formatting */
        p = put_str(p, "MD:Z:", 5);
        { long lo = mdoff[i], hiM = mdoff[i + 1];
          long span = li - t5[i] - t3[i];
          if (hiM == lo) p = put_long(p, span);
          else {
              p = put_long(p, mdpos[lo]); *p++ = mdch[lo];
              for (long k = lo + 1; k < hiM; k++) {
                  long gap = mdpos[k] - mdpos[k - 1] - 1;
                  if (gap > 0) p = put_long(p, gap);
                  *p++ = mdch[k];
              }
              long rem = span - 1 - mdpos[hiM - 1];
              if (rem > 0) p = put_long(p, rem);
          }
        }
        p = put_str(p, "\tNH:i:", 6); p = put_long(p, nh[i]);
        p = put_str(p, "\tHI:i:", 6); p = put_long(p, hi[i]);
        p = put_str(p, "\tNM:i:", 6); p = put_long(p, nm[i]);
        p = put_str(p, "\tSM:i:", 6); p = put_long(p, mapq[i]);
        p = put_str(p, "\tXQ:i:", 6); p = put_long(p, xq[i]);
        p = put_str(p, "\tX2:i:", 6); p = put_long(p, x2[i]);
        *p++ = '\n';
    }
    out_off[n] = p - buf;
    return p - buf;
}
